"""The legacy seq2seq decoder and its beam decode against the JAX package's,
in f32 at the tiny configuration through the weight bridge: the full
forward's logits, the cached one-token steps against the full forward, and
``generate_seq2seq``'s beams (plain, and with unordered and ordered
constraints) token for token."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import loaded, max_err, t

from multimodalvc_tpu.nn import seq2seq as js2s
from multimodalvc_tpu.ops import constraints as jcons
from multimodalvc_tpu_torch.nn import seq2seq as ts2s
from multimodalvc_tpu_torch.ops import constraints as tcons

# f32 logits of two tiny layers: 1e-4 of O(1) values (test_torch_encoders.py);
# the beams' scores (sums of up to 12 log-probs) to 1e-4
TOL, SCORE_TOL = 1e-4, 1e-4
B, S, VOCAB = 3, 7, 64


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((B, S, 32)).astype(np.float32)
    lens = np.asarray([7, 4, 1], np.int32)
    tokens = rng.integers(3, VOCAB, (B, 5)).astype(np.int32)
    jm = js2s.Seq2SeqDecoder(js2s.Seq2SeqDecoderConfig.tiny(VOCAB))
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(tokens), jnp.asarray(enc),
                         jnp.asarray(lens))
    v = jax.tree.map(np.asarray, v)
    tm = loaded(ts2s.Seq2SeqDecoder(ts2s.Seq2SeqDecoderConfig.tiny(VOCAB)), v)
    return jm, v, tm, enc, lens, tokens


def test_decoder_forward_matches_jax():
    jm, v, tm, enc, lens, tokens = _setup()
    want = jax.jit(jm.apply)(v, jnp.asarray(tokens), jnp.asarray(enc), jnp.asarray(lens))
    with torch.no_grad():
        got = tm(t(tokens).long(), t(enc), t(lens))
    assert got["cache"] is None and got["logits"].dtype == torch.float32
    assert max_err(want["logits"], got["logits"]) < TOL


def test_cached_steps_match_the_full_forward():
    """BOS then four tokens one step at a time through the cache (written at
    its index) give the full causal forward's logits; the cache leaves are
    [B, L, H, Dh]."""
    _, _, tm, enc, lens, tokens = _setup(1)
    with torch.no_grad():
        full = tm(t(tokens).long(), t(enc), t(lens))["logits"]
        cache = tm.init_cache(B, tokens.shape[1])
        assert cache[0]["k"].shape == (B, tokens.shape[1], 2, 16) and cache[0]["index"] == 0
        for i in range(tokens.shape[1]):
            out = tm(t(tokens[:, i: i + 1]).long(), t(enc), t(lens),
                     positions=torch.full((B, 1), i), cache=cache)
            cache = out["cache"]
            assert cache[0]["index"] == i + 1
            torch.testing.assert_close(out["logits"][:, 0], full[:, i], rtol=0, atol=1e-5)


CONSTRAINTS = [[[5, 6]], [[9], [12, 13]], []]


@pytest.mark.parametrize("mode", [None, "unordered", "ordered"])
def test_generate_seq2seq_matches_jax(mode):
    jm, v, tm, enc, lens, _ = _setup(2)
    kw = dict(bos_token_id=0, max_new_tokens=12, num_beams=4)
    jkw, tkw = dict(kw), dict(kw)
    if mode:
        jkw.update(constraints=jcons.pack_constraints(CONSTRAINTS), constraints_mode=mode)
        tkw.update(constraints=tcons.pack_constraints(CONSTRAINTS), constraints_mode=mode)
    want_seqs, want_scores = js2s.generate_seq2seq(jm, v, jnp.asarray(enc), jnp.asarray(lens),
                                                   **jkw)
    got_seqs, got_scores = ts2s.generate_seq2seq(tm, t(enc), t(lens), **tkw)
    assert got_seqs.shape == (B, 4, 12)
    np.testing.assert_array_equal(got_seqs.numpy(), np.asarray(want_seqs))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores), rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    if mode:  # every constraint of a row is in its best beam
        for row, phrases in zip(got_seqs[:, 0].tolist(), CONSTRAINTS):
            for p in phrases:
                assert any(row[i: i + len(p)] == p for i in range(len(row))), (row, p)


def test_topk_plan_covers_the_seq2seq_vocabulary():
    """K4's plan at the default decoder's decode step ([8 x 5, 1000], n = 10):
    blocks of a multiple of 8 columns that cover V with none empty, each
    block's whole range in its copy ring, the shared memory within a block's;
    and the kernel's plain version on the CPU keeps lax.top_k's tie order."""
    from multimodalvc_tpu_torch.ops import topk as tk

    plan = tk.topk_plan(8, 5, 1000, 10)
    assert plan.cols % 8 == 0 and plan.cluster * plan.cols >= 1000
    assert (plan.cluster - 1) * plan.cols < 1000 and plan.cluster <= tk.TOPK_MAX_CLUSTER
    assert plan.stages == tk.topk_chunks(plan.cols)
    assert tk.topk_smem_bytes(5, 10, plan.cluster, plan.stages) <= tk.TOPK_SMEM_MAX
    logits = torch.zeros(40, 1000)
    logits[0, 3] = logits[0, 7] = 5.0
    logits[1] = logits[0]
    vals, idx = tk.beam_topk_columns(logits, None, None, torch.zeros(8, 5), 10)
    assert idx[0, :4].tolist() == [3, 7, 1003, 1007] and vals.shape == (8, 10)
