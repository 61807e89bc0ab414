"""The decode modes of ops/beam_search.py against the JAX package's, both
driven by the same deterministic stand-in decoder (a numpy logits table
indexed by token and position, plus a per-beam cache term, so that a wrong
beam reorder changes the result): the search logic held apart from the model.
Tokens must be identical; scores within 1e-5 (sums of f32 log-probs)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.ops import constraints as JC
from multimodalvc_tpu_torch.ops import beam_search as tbs
from multimodalvc_tpu_torch.ops import constraints as TC

# the package's ops/__init__ exports a function of the same name
jbs = importlib.import_module("multimodalvc_tpu.ops.beam_search")
EOS, PAD = 2, 0


class Decoder:
    """logits = table[(token * 7 + position) % P] + h * w, where the cache
    leaf h [B*K, 1] follows the beams; for both packages."""

    def __init__(self, table, w, b, k, first, lens):
        self.table, self.w, self.b, self.k = table, w, b, k
        self.first, self.lens = first, lens

    def jax_args(self):
        table, w, vocab = jnp.asarray(self.table), jnp.asarray(self.w), self.table.shape[1]

        def decode_fn(tokens, positions, cache):
            h = cache["h"] * 0.5 + tokens.astype(jnp.float32) / vocab
            row = (tokens[:, 0] * 7 + positions[:, 0]) % table.shape[0]
            return table[row] + h * w[None, :], {**cache, "h": h}

        cache = {"h": jnp.zeros((self.b * self.k, 1), jnp.float32)}
        return decode_fn, cache, jnp.asarray(self.lens), jnp.asarray(self.first)

    def torch_args(self):
        table, w, vocab = t(self.table), t(self.w), self.table.shape[1]

        def decode_fn(tokens, positions, cache):
            h = cache["h"] * 0.5 + tokens.to(torch.float32) / vocab
            row = (tokens[:, 0] * 7 + positions[:, 0]) % table.shape[0]
            return table[row] + h * w[None, :], {**cache, "h": h}

        return decode_fn, {"h": torch.zeros(self.b * self.k, 1)}, t(self.lens), t(self.first)


def _decoder(seed, b, k, vocab, scale=2.0, p=37):
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((p, vocab)) * scale).astype(np.float32)
    w = rng.standard_normal(vocab).astype(np.float32)
    first = (rng.standard_normal((b, vocab)) * scale).astype(np.float32)
    return Decoder(table, w, b, k, first, np.asarray([9, 4, 6][:b], np.int32))


def _same(want, got, atol=1e-5):
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_allclose(np.asarray(want[1]), got[1].numpy(), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("ngram", [2, 3, 4])
def test_apply_ngram_block_matches_jax(ngram):
    """Every step from 0 (step < n - 1 blocks nothing) to the budget, over
    sequences of a 4-token alphabet, so that n-grams repeat."""
    rng = np.random.default_rng(ngram)
    b, k, l, vocab = 2, 3, 9, 12
    logp = rng.standard_normal((b, k, vocab)).astype(np.float32)
    seqs = rng.integers(0, 4, (b, k, l)).astype(np.int32)
    blocked = 0
    for step in range(l + 1):
        want = jbs.apply_ngram_block(jnp.asarray(logp), jnp.asarray(seqs), jnp.int32(step), ngram)
        got = tbs.apply_ngram_block(t(logp), t(seqs).long(), step, ngram)
        np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=f"step {step}")
        if step < ngram - 1:
            assert torch.equal(got, t(logp))
        blocked += int((got == tbs.NEG_INF).sum())
    assert blocked > 0


@pytest.mark.parametrize("ngram", [2, 3])
def test_ngram_beam_search_matches_jax(ngram):
    """An 8-token vocabulary and 16 tokens, so that the blocked search
    departs from the plain one."""
    dec = _decoder(5, 2, 3, 8)
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, max_new_tokens=16, num_beams=3)
    jfn, jc, jl, jf = dec.jax_args()
    want = jbs.beam_search(jfn, jc, jl, jf, no_repeat_ngram_size=ngram, **kw)
    fn, c, lens, first = dec.torch_args()
    got = tbs.beam_search(fn, c, lens, first, no_repeat_ngram_size=ngram, **kw)
    _same(want, got)
    plain = tbs.beam_search(*dec.torch_args(), **kw)
    assert not torch.equal(plain[0], got[0])


def test_greedy_matches_jax():
    dec = _decoder(6, 3, 1, 50)
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, max_new_tokens=10)
    want = jbs.greedy_search(*dec.jax_args(), **kw)
    got = tbs.greedy_search(*dec.torch_args(), **kw)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8), (1.3, 7, 0.9), (0.5, 1, 0.3),
])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((4, 64)) * 2.0).astype(np.float32)
    want = jbs._filter_logits(jnp.asarray(logits), temperature, top_k, top_p)
    got = tbs._filter_logits(t(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_sample_top1_is_greedy():
    """Sampling from the top-1 filter is greedy decoding, in both packages
    (their random bits differ, so nothing else can be compared exactly)."""
    dec = _decoder(8, 3, 1, 50)
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, max_new_tokens=10)
    want = jbs.greedy_search(*dec.jax_args(), **kw)
    jax_sampled = jbs.sample_search(*dec.jax_args(), rng=jax.random.PRNGKey(0), top_k=1, **kw)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(jax_sampled))
    got = tbs.sample_search(*dec.torch_args(), generator=torch.Generator().manual_seed(0),
                            top_k=1, **kw)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # and sampling does sample: a flat filter draws other tokens
    spread = tbs.sample_search(*dec.torch_args(), generator=torch.Generator().manual_seed(0),
                               temperature=5.0, **kw)
    assert not torch.equal(spread, got)


@pytest.mark.parametrize("groups", [2, 3])
def test_diverse_beam_search_matches_jax(groups):
    dec = _decoder(9, 2, 6, 40)
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, max_new_tokens=8, num_beams=6,
              num_groups=groups, diversity_strength=0.5)
    want = jbs.diverse_beam_search(*dec.jax_args(), **kw)
    got = tbs.diverse_beam_search(*dec.torch_args(), **kw)
    _same(want, got)


def _contains(row, phrase):
    row = list(row)
    return any(row[i : i + len(phrase)] == phrase for i in range(len(row) - len(phrase) + 1))


# (constraints per row, table scale, vocab, budget, a tweak of the decoder)
CASES = {
    # candidate scores 60x spread: banks interleave in the sort (MAX_SCORE = -100)
    "score_spread": ([[[5, 6]], [[9], [11, 12]]], 60.0, 24, 8, None),
    # the constraint tokens are every beam's favourites, so the top-2K, the
    # top-1 and the constraint candidates name the same (beam, token)
    "dedup_collision": ([[[5, 6]], [[7]]], 2.0, 24, 8, "favour_constraints"),
    # EOS dominates every row of the table: banned until the constraints are met
    "eos_ban": ([[[5, 6]], [[9]]], 2.0, 24, 8, "favour_eos"),
    # a phrase longer than the budget: nothing satisfied, the live beams return
    "nothing_satisfied": ([[[5, 6, 7, 8, 9]], [[3, 4, 10, 11]]], 2.0, 24, 3, None),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["unordered", "ordered"])
def test_constrained_beam_search_matches_jax(mode, case):
    cons, scale, vocab, budget, tweak = CASES[case]
    dec = _decoder(10, 2, 3, vocab, scale=scale)
    if tweak == "favour_constraints":
        dec.table[:, [5, 6, 7]] += 6.0
        dec.first[:, [5, 7]] += 6.0
    if tweak == "favour_eos":
        dec.table[:, EOS] += 8.0
        dec.first[:, EOS] += 8.0
    packed = JC.pack_constraints(cons)
    build = (JC.build_unordered, TC.build_unordered) if mode == "unordered" else (
        JC.build_ordered, TC.build_ordered)
    kw = dict(eos_token_id=EOS, pad_token_id=PAD, max_new_tokens=budget, num_beams=3, mode=mode)
    want = jbs.constrained_beam_search(*dec.jax_args(), constraint_set=build[0](packed), **kw)
    got = tbs.constrained_beam_search(*dec.torch_args(), constraint_set=build[1](packed), **kw)
    _same(want, got)
    best = got[0][:, 0].tolist()
    if case == "nothing_satisfied":
        assert all(np.isfinite(got[1].numpy()).ravel()) and not (got[0] == PAD).all()
        return
    for row, phrases in zip(best, cons):
        assert all(_contains(row, p) for p in phrases), (row, phrases)
    if case == "eos_ban":
        plain = tbs.beam_search(*dec.torch_args(), eos_token_id=EOS, pad_token_id=PAD,
                                max_new_tokens=budget, num_beams=3)
        assert plain[0][0, 0, 0] == EOS  # unconstrained, EOS comes first
        for row, phrases in zip(best, cons):
            if EOS in row:
                end = max(i + len(p) for p in phrases for i in range(len(row))
                          if row[i : i + len(p)] == p)
                assert row.index(EOS) >= end
