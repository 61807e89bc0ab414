"""K2/K3 parity: the port's prompt_attention and gen_attention_ancestor (plain
versions on the CPU) against the JAX Pallas kernels in interpret mode, with
int8, bf16 and f32 KV, plus quantize_kv and merge_softmax_segments."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, t

from multimodalvc_tpu.ops import decode_attention as jda
from multimodalvc_tpu_torch.ops import decode_attention as tda

B, BEAMS, G, H, D, TP, L = 2, 3, 2, 4, 16, 12, 8
SCALE = D ** -0.5
# f32 softmax partials; the unnormalised out sums up to TP values of |v| ~ 1,
# so 1e-4 absolute is ~1e-6 relative (summation order only)
TOL = 1e-4


def _kv(rng, shape, kv):
    """(JAX array, torch tensor, JAX scales, torch scales) of one KV operand."""
    x = rng.standard_normal(shape).astype(np.float32)
    if kv == "f32":
        return jnp.asarray(x), t(x), None, None
    if kv == "bf16":  # the same bf16 values on both sides
        xb = jnp.asarray(x, jnp.bfloat16)
        return xb, t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), None, None
    q, s = jda.quantize_kv(jnp.asarray(x))
    return q, t(np.asarray(q)), s, t(np.asarray(s))


KV_TYPES = ["int8", "f32", "bf16"]


def test_quantize_kv_matches_jax_and_rounds_half_to_even():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 0, :4] = [127.0, 2.5, -3.5, 0.5]  # scale 1.0: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0
    wq, ws = jda.quantize_kv(jnp.asarray(x))
    gq, gs = tda.quantize_kv(t(x))
    np.testing.assert_array_equal(np.asarray(wq), gq.numpy())
    np.testing.assert_array_equal(np.asarray(ws), gs.numpy())
    assert gq[0, 0, :4].tolist() == [127, 2, -4, 0]


@pytest.mark.parametrize("kv", KV_TYPES, ids=KV_TYPES)
def test_prompt_attention_matches_jax_kernel(kv):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B * BEAMS, H, D)).astype(np.float32)
    jk, tk, jks, tks = _kv(rng, (B, G, TP, D), kv)
    jv, tv, jvs, tvs = _kv(rng, (B, G, TP, D), kv)
    mask = np.ones((B, TP), np.int32)
    mask[0, :5] = 0  # left pad
    mask[1] = 0  # no valid prompt slot: (0, -1e30, 0)
    want = jda.prompt_attention(jnp.asarray(q), jk, jv, jnp.asarray(mask), beams=BEAMS,
                                scale=SCALE, interpret=True, k_scale=jks, v_scale=jvs)
    got = tda.prompt_attention(t(q), tk, tv, t(mask), beams=BEAMS, scale=SCALE,
                               k_scale=tks, v_scale=tvs)
    for w, g in zip(want, got):
        assert max_err(w, g) < TOL


@pytest.mark.parametrize("valid", [5, 0])
@pytest.mark.parametrize("kv", KV_TYPES, ids=KV_TYPES)
def test_gen_attention_ancestor_matches_jax_kernel(kv, valid):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B * BEAMS, H, D)).astype(np.float32)
    jk, tk, jks, tks = _kv(rng, (B * BEAMS, L, G, D), kv)
    jv, tv, jvs, tvs = _kv(rng, (B * BEAMS, L, G, D), kv)
    anc = rng.integers(0, BEAMS, (B * BEAMS, L)).astype(np.int32)
    jkw = dict() if jks is None else dict(k_scale=jks, v_scale=jvs)
    want = jda.gen_attention_ancestor(jnp.asarray(q), jk, jv, jnp.asarray(anc), jnp.int32(valid),
                                      beams=BEAMS, scale=SCALE, interpret=True, **jkw)
    got = tda.gen_attention_ancestor(t(q), tk, tv, t(anc), valid, beams=BEAMS, scale=SCALE,
                                     k_scale=tks, v_scale=tvs)
    for w, g in zip(want, got):
        assert max_err(w, g) < TOL
    if valid == 0:
        assert torch.all(got[0] == 0) and torch.all(got[1] == -1e30) and torch.all(got[2] == 0)


def test_merge_softmax_segments_matches_jax():
    rng = np.random.default_rng(3)
    parts = [rng.standard_normal(s).astype(np.float32) for s in
             [(4, 3, 8), (4, 3), (4, 3), (4, 3, 8), (4, 3), (4, 3)]]
    parts[2], parts[5] = np.abs(parts[2]) + 0.1, np.abs(parts[5]) + 0.1
    parts[4][0] = -1e30  # an empty segment merges as a no-op
    parts[5][0] = 0.0
    want = jda.merge_softmax_segments(*map(jnp.asarray, parts))
    got = tda.merge_softmax_segments(*map(t, parts))
    assert max_err(want, got) < 1e-6
