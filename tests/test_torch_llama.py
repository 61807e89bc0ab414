"""LLaMA parity through the weight bridge (tiny config, f32): RoPE, RMSNorm,
the plain forward, the left-padded prefill into the KV cache, and two
ancestry int8-KV decode steps with a beam reorder between them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, randomize, t

from multimodalvc_tpu.nn import llama as jl
from multimodalvc_tpu.ops.beam_search import _gather_beams as jax_gather_beams
from multimodalvc_tpu.ops.decode_attention import quantize_kv as jax_quantize_kv
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.ops.beam_search import _gather_beams as torch_gather_beams

B, T, BEAMS, NEW = 2, 9, 3, 6
# f32 through two decoder layers and the tied unembed (~1e-6 relative)
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jm = jl.LlamaModel(jl.LlamaConfig.tiny(vocab_size=64))
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((B, T, 64)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0  # left pad
    v = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), inputs_embeds=jnp.asarray(emb)))
    tm = loaded(tl.LlamaModel(tl.LlamaConfig.tiny(vocab_size=64)), v)
    return jm, v, tm, emb, mask


def test_rope_and_rmsnorm():
    cfg = jl.LlamaConfig()
    np.testing.assert_array_equal(jl.llama3_rope_frequencies(cfg),
                                  tl.llama3_rope_frequencies(tl.LlamaConfig()))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    inv = jl.llama3_rope_frequencies(jl.LlamaConfig.tiny())
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv))
    assert max_err(want, tl.apply_rope(t(x), t(pos), t(inv))) < 1e-5
    h = rng.standard_normal((2, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    norm = tl.RMSNorm(16)
    norm.weight.data = t(scale)
    want = jl.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(h))
    assert max_err(want, norm(t(h))) < 1e-5


def test_forward_logits(pair):
    jm, v, tm, emb, mask = pair
    want = jax.jit(lambda e, m: jm.apply(v, inputs_embeds=e, attn_mask=m)["logits"])(
        jnp.asarray(emb), jnp.asarray(mask))
    got = tm(inputs_embeds=t(emb), attn_mask=t(mask))["logits"]
    assert max_err(want, got) < TOL


def _jax_prefill(jm, v, emb, mask):
    """The JAX generate_beam prefill and int8 ancestry cache (nn/llama.py:728-799)."""
    cache = jm.apply(v, method=jl.LlamaModel.init_cache, batch=B, max_len=T, dtype=jnp.float32)
    rope_pos = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0)
    slot_pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    out = jm.apply(v, inputs_embeds=emb, attn_mask=mask, positions=rope_pos, cache=cache,
                   cache_positions=slot_pos, logits_last_only=True)
    cfg = jm.cfg
    gen = (B * BEAMS, NEW, cfg.num_kv_heads, cfg.head_dim)
    caches = []
    for c in out["cache"]:
        pk, pks = jax_quantize_kv(c["k"])
        pv, pvs = jax_quantize_kv(c["v"])
        caches.append({
            "prompt_k": pk, "prompt_v": pv, "prompt_ks": pks, "prompt_vs": pvs,
            "prompt_mask": mask, "fixed_k": jnp.zeros(gen, jnp.int8),
            "fixed_v": jnp.zeros(gen, jnp.int8), "fixed_ks": jnp.zeros(gen[:3], jnp.float32),
            "fixed_vs": jnp.zeros(gen[:3], jnp.float32),
            "anc": jnp.zeros((B * BEAMS, NEW), jnp.int32), "index": jnp.zeros((), jnp.int32),
        })
    return out["logits"][:, -1], tuple(caches), jnp.sum(mask, axis=1)


def test_prefill_and_ancestry_decode_steps(pair):
    jm, v, tm, emb, mask = pair
    j_first, j_cache, j_lens = _jax_prefill(jm, v, jnp.asarray(emb), jnp.asarray(mask))
    t_first, t_cache, t_lens = tl.prefill_split_cache(
        tm, t(emb), t(mask), num_beams=BEAMS, max_new_tokens=NEW, ancestry_reorder=True,
        kv_quant="int8", cache_dtype=torch.float32)
    assert max_err(j_first, t_first) < TOL
    np.testing.assert_array_equal(np.asarray(j_lens), t_lens.numpy())
    np.testing.assert_array_equal(np.asarray(j_cache[0]["prompt_k"]), t_cache[0]["prompt_k"].numpy())

    rng = np.random.default_rng(2)
    reorder = np.asarray([[2, 0, 0], [1, 1, 2]], np.int32)  # beam parents after step 1
    for step in (1, 2):
        tokens = rng.integers(0, 64, (B * BEAMS, 1)).astype(np.int32)
        pos = (np.repeat(np.asarray(j_lens), BEAMS) + step - 1)[:, None].astype(np.int32)
        out = jm.apply(v, input_ids=jnp.asarray(tokens), attn_mask=None,
                       positions=jnp.asarray(pos), cache=j_cache)
        j_logits, j_cache = out["logits"][:, -1], out["cache"]
        t_logits, t_cache = tl.decode_step(tm, t(tokens).long(), t(pos), t_cache)
        # int8 KV: an f32 last-bit difference can move one value across a
        # rounding boundary (one quantization step of ~|k|max/127), which
        # moves the logits by ~1e-3 at most at these widths
        assert max_err(j_logits, t_logits) < 2e-3, step
        np.testing.assert_array_equal(np.asarray(j_cache[1]["anc"]), t_cache[1]["anc"].numpy())
        j_cache = jax_gather_beams(j_cache, jnp.asarray(reorder), B, BEAMS)
        t_cache = torch_gather_beams(t_cache, t(reorder).long(), B, BEAMS)
    assert t_cache[0]["index"] == 2
