"""K4 and beam-search parity: the port's beam_topk_columns (plain version on
the CPU) against the JAX Pallas kernel in interpret mode, the lax.top_k tie
order, and beam_search against the JAX beam_search on the same decoder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.ops.beam_search import beam_search as jax_beam_search
from multimodalvc_tpu.ops import topk as jtopk
from multimodalvc_tpu_torch.ops import beam_search as tbs
from multimodalvc_tpu_torch.ops import topk as ttopk


def _row_stats(lf):
    row_max = jnp.max(lf, axis=-1, keepdims=True)
    return row_max, jnp.log(jnp.sum(jnp.exp(lf - row_max), axis=-1, keepdims=True))


def test_beam_topk_columns_matches_jax_kernel_exactly():
    """Values and indices bit-exact, with three winners in one column, two
    beams that tie on every candidate and a tie across columns."""
    rng = np.random.default_rng(0)
    b, k, v, n = 3, 5, 4096, 10
    logits = (rng.standard_normal((b * k, v)) * 4.0).astype(np.float32)
    logits[0, 77], logits[2, 77], logits[4, 77] = 40.0, 39.5, 39.0
    logits[k + 3] = logits[k + 1]
    logits[2 * k, 5] = logits[2 * k, 3000] = 25.0
    scores = rng.standard_normal((b, k)).astype(np.float32)
    scores[1, 3] = scores[1, 1]
    lf = jnp.asarray(logits)
    row_max, row_ls = _row_stats(lf)
    want_v, want_i = jtopk.beam_topk_columns(lf, row_max, row_ls, jnp.asarray(scores), n,
                                             interpret=True)
    got_v, got_i = ttopk.beam_topk_columns(t(logits), t(row_max), t(row_ls), t(scores), n)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_array_equal(np.asarray(want_v), got_v.numpy())
    assert got_i.dtype == torch.int32


@pytest.mark.parametrize("n", [3, 7])
def test_top_k_keeps_lax_tie_order(n):
    rng = np.random.default_rng(1)
    x = np.round(rng.standard_normal((4, 40)), 1).astype(np.float32)  # many ties
    x[2, ::3] = -3.0e38  # saturated knock-out values tie too
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), n)
    got_v, got_i = ttopk.top_k(t(x), n)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_array_equal(np.asarray(want_v), got_v.numpy())


def _jax_decoder(table, w):
    """A deterministic stand-in decoder: logits from a table indexed by
    (token, position) plus a term from a per-beam cache leaf, so beam
    reordering of the cache changes the result."""
    p, vocab = table.shape

    def decode_fn(tokens, positions, cache):
        h = cache["h"] * 0.5 + tokens.astype(jnp.float32) / vocab
        row = (tokens[:, 0] * 7 + positions[:, 0]) % p
        return table[row] + h * w[None, :], {**cache, "h": h}

    return decode_fn


@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
def test_beam_search_matches_jax(length_penalty):
    rng = np.random.default_rng(2)
    b, k, vocab, steps, eos, pad = 2, 3, 64, 7, 5, 0
    table = (rng.standard_normal((50, vocab)) * 2.0).astype(np.float32)
    table[::3, eos] += 5.0  # EOS competes often: the finished pool matters
    w = rng.standard_normal(vocab).astype(np.float32)
    first = rng.standard_normal((b, vocab)).astype(np.float32)
    lens = np.asarray([9, 4], np.int32)
    cache = {"h": np.zeros((b * k, 1), np.float32), "fixed_z": np.ones((b * k, 1), np.float32)}
    kw = dict(eos_token_id=eos, pad_token_id=pad, max_new_tokens=steps, num_beams=k,
              length_penalty=length_penalty)

    jdec = _jax_decoder(jnp.asarray(table), jnp.asarray(w))
    want_s, want_sc = jax_beam_search(jdec, jax.tree.map(jnp.asarray, cache),
                                      jnp.asarray(lens), jnp.asarray(first), **kw)

    def tdec(tokens, positions, c):
        h = c["h"] * 0.5 + tokens.to(torch.float32) / vocab
        row = (tokens[:, 0] * 7 + positions[:, 0]) % table.shape[0]
        return t(table)[row] + h * t(w)[None, :], {**c, "h": h}

    got_s, got_sc = tbs.beam_search(tdec, {kk: t(x) for kk, x in cache.items()}, t(lens),
                                    t(first), **kw)
    np.testing.assert_array_equal(np.asarray(want_s), got_s.numpy())
    np.testing.assert_allclose(np.asarray(want_sc), got_sc.numpy(), rtol=1e-5, atol=1e-5)


def test_gather_beams_skips_fixed_leaves():
    idx = torch.tensor([[2, 2, 0], [1, 0, 0]])
    x = torch.arange(6).reshape(6, 1)
    tree = ({"anc": x, "fixed_k": x, "index": 3, "prompt_mask": torch.ones(2, 4)},)
    out = tbs._gather_beams(tree, idx, 2, 3)[0]
    assert out["anc"][:, 0].tolist() == [2, 2, 0, 4, 3, 3]
    assert out["fixed_k"] is x and out["index"] == 3
    assert out["prompt_mask"] is tree[0]["prompt_mask"]


def _k5_inputs(rng, b, k, v, dtype):
    """Log-probs [B, K, V] with ties within a row, across rows and at the
    -1e7 "banned" value, which the n-gram block writes."""
    logp = (rng.standard_normal((b, k, v)) * 3.0 - 8.0).astype(np.float32)
    logp[:, :, rng.integers(0, v, 40)] = -1.0e7  # bans
    logp[0, 0, 11] = logp[0, 2, 11] = 20.0  # a tie across rows
    logp[0, 0, 700] = logp[0, 2, 3] = 19.0  # and one across columns
    logp[1, 1] = logp[1, 0]  # two beams tie on every candidate
    logp[1, 2, :] = -1.0e7  # a beam with everything banned
    scores = rng.standard_normal((b, k)).astype(np.float32)
    scores[0, 2] = scores[0, 0]
    scores[1, 1] = scores[1, 0]
    j = jnp.asarray(logp).astype(dtype)
    return j, t(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), scores


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_beam_topk_matches_jax_kernel_exactly(dtype):
    """K5 on log-probs (the n-gram path): indices and values bit-equal to the
    JAX Pallas kernel in interpret mode, in f32 and bf16."""
    rng = np.random.default_rng(3)
    b, k, v, n = 2, 3, 1000, 6
    jlogp, tlogp, scores = _k5_inputs(rng, b, k, v, dtype)
    want_v, want_i = jtopk.beam_topk(jlogp, jnp.asarray(scores), n, interpret=True)
    got_v, got_i = ttopk.beam_topk(tlogp, t(scores), n)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_array_equal(np.asarray(want_v), got_v.numpy())
    assert got_i.dtype == torch.int32
    assert got_i[0, :4].tolist() == [11, 2 * v + 11, 700, 2 * v + 3]  # lowest flat first


def test_beam_topk_from_logits_matches_jax_kernel_exactly():
    """K5 from raw logits at V % 8 != 0 (V = 1001), bit-equal."""
    rng = np.random.default_rng(4)
    b, k, v, n = 2, 3, 1001, 6
    logits = (rng.standard_normal((b * k, v)) * 4.0).astype(np.float32)
    logits[0, 5] = logits[0, 1000] = logits[2, 5] = 30.0
    logits[k + 2] = logits[k]
    scores = rng.standard_normal((b, k)).astype(np.float32)
    scores[1, 2] = scores[1, 0]
    lf = jnp.asarray(logits)
    row_max, row_ls = _row_stats(lf)
    want_v, want_i = jtopk.beam_topk_from_logits(lf, row_max, row_ls, jnp.asarray(scores), n,
                                                 interpret=True)
    got_v, got_i = ttopk.beam_topk_from_logits(t(logits), t(row_max), t(row_ls), t(scores), n)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_array_equal(np.asarray(want_v), got_v.numpy())
