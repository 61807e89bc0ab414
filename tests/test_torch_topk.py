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


# ---- the statistics inside the kernel (None row_max / row_logsumexp) ---------

# the port's row logsumexp against JAX's on the CPU: the two sum in other
# orders, a few f32 ulps apart; the values inherit that difference plus two
# roundings of each value
LS_TOL = 2e-6


def _value_tol(ls_err, values):
    return ls_err + 2 * np.finfo(np.float32).eps * float(np.abs(values).max())


@pytest.mark.parametrize("entry, v", [("beam_topk_columns", 4096), ("beam_topk_from_logits", 1001)])
def test_statistics_inside_match_jax_kernel(entry, v):
    """None statistics: the port computes each row's max and logsumexp
    itself.  Against the JAX kernel in interpret mode fed JAX's own
    statistics: indices equal on the planted ties, the max exact, the
    logsumexp and the values within LS_TOL."""
    rng = np.random.default_rng(5)
    b, k, n = 3, 5, 10
    logits = (rng.standard_normal((b * k, v)) * 4.0).astype(np.float32)
    logits[0, 77], logits[2, 77], logits[4, 77] = 40.0, 39.5, 39.0  # 3 winners, 1 column
    logits[k + 3] = logits[k + 1]  # two beams tie on every candidate
    logits[2 * k, 5] = logits[2 * k, v - 1] = 25.0  # a tie across columns
    scores = rng.standard_normal((b, k)).astype(np.float32)
    scores[1, 3] = scores[1, 1]
    lf = jnp.asarray(logits)
    row_max, row_ls = _row_stats(lf)
    want_v, want_i = getattr(jtopk, entry)(lf, row_max, row_ls, jnp.asarray(scores), n,
                                           interpret=True)
    m, ls = torch.empty(b * k), torch.empty(b * k)
    got_v, got_i = getattr(ttopk, entry)(t(logits), None, None, t(scores), n, stats_out=(m, ls))
    np.testing.assert_array_equal(m.numpy(), np.asarray(row_max)[:, 0])
    ls_err = float(np.abs(ls.numpy() - np.asarray(row_ls)[:, 0]).max())
    assert ls_err <= LS_TOL
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=_value_tol(ls_err, np.asarray(want_v)))


def test_plain_with_none_statistics_equals_plain_given_them():
    """The plain version with None computes the statistics as the beam step
    did in PyTorch (``row_stats``): bit for bit the plain version given
    them, and ``stats_out`` holds them."""
    rng = np.random.default_rng(6)
    b, k, v, n = 2, 5, 2048, 10
    logits = t((rng.standard_normal((b * k, v)) * 3.0).astype(np.float32))
    scores = t(rng.standard_normal((b, k)).astype(np.float32))
    row_max = logits.amax(dim=-1, keepdim=True)
    row_ls = torch.log(torch.exp(logits - row_max).sum(dim=-1, keepdim=True))
    m, ls = torch.empty(b * k), torch.empty(b * k)
    got = ttopk.beam_topk_columns_plain(logits, None, None, scores, n, stats_out=(m, ls))
    want = ttopk.beam_topk_columns_plain(logits, row_max, row_ls, scores, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(m, row_max[:, 0]) and torch.equal(ls, row_ls[:, 0])
    for fn in (ttopk.beam_topk_columns, ttopk.beam_topk_from_logits):
        again = fn(logits, None, None, scores, n)
        assert torch.equal(again[0], want[0]) and torch.equal(again[1], want[1])


@pytest.mark.parametrize("batch, beams, vocab, n, itemsize", [
    (8, 5, 128256, 10, 4), (48, 5, 128256, 10, 4), (8, 5, 128256, 10, 2),
    (48, 5, 128250, 10, 4), (4, 5, 128256, 10, 4), (1, 5, 1001, 10, 4),
    (16, 8, 128256, 16, 4), (2, 16, 32000, 32, 4), (3, 2, 7, 14, 4), (200, 5, 128256, 10, 2),
])
def test_topk_plan(batch, beams, vocab, n, itemsize):
    """Every column is owned by exactly one block, the cluster is at most 16
    (one of the table's sizes, or fewer where V leaves the last blocks no
    column), the ring is 1-8 chunks and no more than a thread streams, the
    block within 227 KB of shared memory with the unit maxima the plan
    carries, phase B reads no chunk twice wherever some cluster size allows
    it, and the plan depends on the shapes alone."""
    plan = ttopk.topk_plan(batch, beams, vocab, n, itemsize)
    assert 1 <= plan.cluster <= ttopk.TOPK_MAX_CLUSTER and plan.cols % 8 == 0
    assert plan in [ttopk.plan_for(vocab, beams, n, c, itemsize=itemsize)
                    for c in ttopk.TOPK_CLUSTERS_AT_ONCE]
    owner = np.zeros(vocab, np.int64)
    for blk in range(plan.cluster):
        cols = np.arange(blk * plan.cols, min((blk + 1) * plan.cols, vocab))
        assert cols.size > 0
        owner[cols] += 1
    assert (owner == 1).all()
    chunks = ttopk.topk_chunks(plan.cols, itemsize)
    assert 1 <= plan.stages <= min(ttopk.TOPK_MAX_STAGES, chunks)
    sums = ttopk.topk_summary_chunks(beams, n, plan.cluster, plan.cols, plan.stages, itemsize)
    assert plan.summary == sums and sums in (0, chunks - plan.stages)
    assert ttopk.topk_smem_bytes(beams, n, plan.cluster, plan.stages, sums) <= ttopk.TOPK_SMEM_MAX
    # the whole range staged, or the chunks that leave the ring summarized,
    # wherever some cluster size allows it
    if plan.stages < chunks and not sums:
        for c in ttopk.TOPK_CLUSTERS_AT_ONCE:
            other = ttopk.plan_for(vocab, beams, n, c, itemsize=itemsize)
            other_chunks = ttopk.topk_chunks(other.cols, itemsize)
            if ttopk.topk_smem_bytes(beams, n, other.cluster, other.stages) > \
                    ttopk.TOPK_SMEM_MAX:
                continue
            assert other.stages < other_chunks and not ttopk.topk_summary_chunks(
                beams, n, other.cluster, other.cols, other.stages, itemsize)
    ttopk.topk_plan.cache_clear()
    assert ttopk.topk_plan(batch, beams, vocab, n, itemsize) == plan


def test_topk_plan_serving_shapes():
    """The decode's [40, 128256]: clusters of 8 (64 blocks, one wave: the
    card holds 15 clusters of 8 but 7 of 16), 4 of a thread's 8 chunks in the
    ring and the unit maxima of the other 4; batch 48 in clusters of 4 (two
    waves; 2 a batch element would stream 27 of 32 chunks again); batch 4
    stages the whole range in clusters of 16; past the wide instance's
    shared memory, and past n = 256, the select form takes the shapes;
    shapes no kernel can take raise."""
    assert ttopk.topk_plan(8, 5, 128256, 10) == ttopk.TopkPlan(8, 16032, 4, 4)
    assert ttopk.topk_summary_chunks(5, 10, 8, 16032, 4) == 4
    assert ttopk.topk_plan(48, 5, 128256, 10) == ttopk.TopkPlan(4, 32064, 2, 14)
    assert ttopk.topk_plan(4, 5, 128256, 10) == ttopk.TopkPlan(16, 8016, 4, 0)
    assert ttopk.topk_chunks(16032) == 8 and ttopk.topk_chunks(8016) == 4
    over = ttopk.topk_max_beams() + 1  # past the wide instance's shared memory
    for wide in [(8, over, 1000, 2 * over), (8, 5, 1000, 257)]:
        assert isinstance(ttopk.topk_plan(*wide), ttopk.SelectPlan)
    for bad in [(0, 5, 1000, 10), (1, 1, 4, 5), (8, 5, 1000, 5001)]:
        with pytest.raises(ValueError, match="beam top-k kernel"):
            ttopk.topk_plan(*bad)


@pytest.mark.parametrize("batch", [8, 48])
@pytest.mark.parametrize("beams", [17, 32, 64])
def test_topk_plan_past_16_beams(batch, beams):
    """More than 16 beams (n = 2 x beams, up to 128) take the wide
    instance: no ring and no unit maxima, columns owned once each, the
    cluster of the fewest waves (the largest such) whose block fits 227 KB;
    the narrow instances keep their plans."""
    n, vocab = 2 * beams, 128256
    assert ttopk.topk_wide(beams, n) and not ttopk.topk_wide(16, 32)
    plan = ttopk.topk_plan(batch, beams, vocab, n)
    assert (plan.stages, plan.summary) == (1, 0) and plan.cols % 8 == 0
    assert (plan.cluster - 1) * plan.cols < vocab <= plan.cluster * plan.cols
    assert ttopk.topk_smem_bytes(beams, n, plan.cluster, 1) <= ttopk.TOPK_SMEM_MAX
    waves = {c: -(-batch // at_once) for c, at_once in ttopk.TOPK_CLUSTERS_AT_ONCE.items()
             if ttopk.topk_smem_bytes(beams, n, c, 1) <= ttopk.TOPK_SMEM_MAX}
    assert plan.cluster == max(c for c, w in waves.items() if w == min(waves.values()))
    # the wide block has no ring: its shared memory does not hold a chunk of rows
    assert ttopk.topk_smem_bytes(beams, n, plan.cluster, 8) == \
        ttopk.topk_smem_bytes(beams, n, plan.cluster, 1)


def test_topk_ceiling_is_at_least_64_beams():
    """The wide instance takes at least 64 beams (n = 128), up to where its
    block no longer fits a cluster of 4 (the measured crossover: past it the
    select form is faster than the wide instance on a cluster of 2, which
    would still fit); above its ceiling the select form takes every width
    the JAX beam search takes (104, 128, 337 beams and more), so
    no beam width passes to a library top-k on the card; its workspace is
    the statistics, keys, histograms, state and ties of each batch
    element."""
    most, smem, limit = ttopk.topk_max_beams(), ttopk.topk_smem_bytes, ttopk.TOPK_SMEM_MAX
    assert most >= 64
    assert ttopk.TOPK_WIDE_MIN_CLUSTER == 4
    assert smem(most, 2 * most, 4, 1) <= limit < smem(most + 1, 2 * most + 2, 4, 1)
    assert smem(most + 1, 2 * most + 2, 2, 1) <= limit
    assert isinstance(ttopk.topk_plan(8, most, 128256, 2 * most), ttopk.TopkPlan)
    for beams in (most + 1, 104, 105, 128, 337, 2000):
        for batch in (1, 8, 48):
            plan = ttopk.topk_plan(batch, beams, 128256, 2 * beams)
            assert isinstance(plan, ttopk.SelectPlan)
            assert 1 <= plan.blocks <= -(-ttopk.SELECT_TARGET_BLOCKS // batch)
    assert ttopk.select_workspace_bytes(8, 128, 256, 66) == \
        8 * (8 * 128 + 8 * 256 + 4 * 2048 + 16 + 4 * 66) + 16


def test_beam_step_passes_no_statistics_to_the_kernel(monkeypatch):
    """On the accelerator, without n-gram blocking, the beam step hands the
    raw logits to the fused entry with None statistics and computes none in
    PyTorch; the tokens are those of the CPU path."""
    rng = np.random.default_rng(7)
    b, k, vocab, steps, eos, pad = 2, 3, 64, 6, 5, 0
    table = t((rng.standard_normal((50, vocab)) * 2.0).astype(np.float32))
    first = t(rng.standard_normal((b, vocab)).astype(np.float32))
    lens = torch.tensor([9, 4])

    def dec(tokens, positions, c):
        h = c["h"] * 0.5 + tokens.to(torch.float32) / vocab
        return table[(tokens[:, 0] * 7 + positions[:, 0]) % 50] + h, {**c, "h": h}

    def run():
        return tbs.beam_search(dec, {"h": torch.zeros(b * k, 1)}, lens, first, eos_token_id=eos,
                               pad_token_id=pad, max_new_tokens=steps, num_beams=k)

    want = run()
    calls = []
    tbs_log_softmax = tbs.log_softmax

    def fused(logits, row_max, row_logsumexp, scores, n):
        calls.append((row_max, row_logsumexp, tuple(logits.shape), n))
        return ttopk.beam_topk_columns_plain(logits, row_max, row_logsumexp, scores, n)

    softmaxes = []

    def counted_log_softmax(x):
        softmaxes.append(tuple(x.shape))
        return tbs_log_softmax(x)

    monkeypatch.setattr(tbs, "_on_accelerator", lambda x: True)
    monkeypatch.setattr(tbs, "beam_topk_columns", fused)
    got = run()
    assert calls and all(c == (None, None, (b * k, vocab), 2 * k) for c in calls)
    assert torch.equal(got[0], want[0]) and torch.allclose(got[1], want[1], atol=1e-5)
    monkeypatch.setattr(tbs, "log_softmax", counted_log_softmax)
    assert torch.equal(run()[0], want[0])
    assert softmaxes == [(b, vocab)]  # the first expansion's only, as in the JAX step
