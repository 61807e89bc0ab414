"""K2/K3 parity: the port's prompt_attention and gen_attention_ancestor (plain
versions on the CPU) against the JAX Pallas kernels in interpret mode, with
int8, bf16 and f32 KV, plus quantize_kv and merge_softmax_segments; the
merged ancestry_attention against the JAX merge of the two kernels; the
split-KV plan; and the int8 ancestry decode step through the merged entry."""
import copy
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, t

from multimodalvc_tpu.ops import decode_attention as jda
from multimodalvc_tpu_torch.nn import llama as tl
from multimodalvc_tpu_torch.ops import decode_attention as tda
from multimodalvc_tpu_torch.ops import kernel_lib

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


def _merged_case(kv, no_prompt_row):
    """q, the two segments' KV (JAX and torch operands) and anc."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B * BEAMS, H, D)).astype(np.float32)
    pk, pv = _kv(rng, (B, G, TP, D), kv), _kv(rng, (B, G, TP, D), kv)
    gk, gv = _kv(rng, (B * BEAMS, L, G, D), kv), _kv(rng, (B * BEAMS, L, G, D), kv)
    anc = rng.integers(0, BEAMS, (B * BEAMS, L)).astype(np.int32)
    mask = np.ones((B, TP), np.int32)
    mask[0, :5] = 0  # left pad
    if no_prompt_row:
        mask[1] = 0  # a batch element with no valid prompt slot
    return q, pk, pv, gk, gv, anc, mask


@pytest.mark.parametrize("no_prompt_row", [True, False], ids=["empty_prompt_row", "full_prompt"])
@pytest.mark.parametrize("valid", [0, 1, L])
@pytest.mark.parametrize("kv", KV_TYPES, ids=KV_TYPES)
def test_ancestry_attention_plain_matches_jax_merge(kv, valid, no_prompt_row):
    """The merged entry's plain version, before the cast to the model dtype,
    against the JAX merge of the two interpret-mode kernels.  With valid 0
    the batch element without a prompt slot has no valid key at all: its
    rows must be exact zeros, as the JAX merge gives them (0 / 1e-30)."""
    q, pk, pv, gk, gv, anc, mask = _merged_case(kv, no_prompt_row)
    jkw = dict() if pk[2] is None else dict(k_scale=pk[2], v_scale=pv[2])
    want_p = jda.prompt_attention(jnp.asarray(q), pk[0], pv[0], jnp.asarray(mask), beams=BEAMS,
                                  scale=SCALE, interpret=True, **jkw)
    jkw = dict() if gk[2] is None else dict(k_scale=gk[2], v_scale=gv[2])
    want_g = jda.gen_attention_ancestor(jnp.asarray(q), gk[0], gv[0], jnp.asarray(anc),
                                        jnp.int32(valid), beams=BEAMS, scale=SCALE,
                                        interpret=True, **jkw)
    want = jda.merge_softmax_segments(*want_p, *want_g)
    got = tda.ancestry_attention(
        t(q), pk[1], pv[1], t(mask), gk[1], gv[1], t(anc), valid, beams=BEAMS, scale=SCALE,
        prompt_k_scale=pk[3], prompt_v_scale=pv[3], gen_k_scale=gk[3], gen_v_scale=gv[3],
        out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert max_err(want, got) < TOL
    if no_prompt_row and valid == 0:
        assert torch.all(got[BEAMS : 2 * BEAMS] == 0)


# (batch, beams, heads, kv heads, head dim, prompt slots, generated slots):
# the serving decode at batch 8 (16 and 64 generated slots) and 48, K2 and
# K3 alone, a prompt of one slot, a long prompt, beams 8 with one head a
# kv head, generated slots that no chunk size divides
PLAN_SHAPES = [
    (8, 5, 24, 8, 128, 130, 16), (8, 5, 24, 8, 128, 130, 64), (48, 5, 24, 8, 128, 130, 64),
    (8, 5, 24, 8, 128, 130, 0), (8, 5, 24, 8, 128, 0, 16), (48, 5, 24, 8, 128, 0, 64),
    (1, 1, 24, 8, 128, 1, 1), (2, 3, 8, 4, 128, 4000, 300), (4, 8, 16, 16, 128, 130, 17),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_decode_plan(shape):
    """Every slot of each segment lands in exactly one chunk, each chunk
    holds a slot, each fits the kernel (prompt chunks of a multiple of 16 up
    to 128 slots, K x generated slots up to 128 key rows), one cluster of 1
    to 7 blocks takes them (blocks loop over the chunks where there are
    more); the plan is a function of the shapes alone, with no valid_len
    among them."""
    b, beams, h, g, d, tp, slots = shape
    plan = tda.decode_plan(*shape)
    for size, chunks, total in ((plan.prompt_slots, plan.prompt_chunks, tp),
                                (plan.gen_slots, plan.gen_chunks, slots)):
        owner = [c for c in range(chunks) for s in range(size * c, min(size * (c + 1), total))]
        assert owner == sorted(owner) and len(owner) == total
        assert set(owner) == set(range(chunks))
    if tp:
        assert plan.prompt_slots % 16 == 0 and plan.prompt_slots <= tda.DECODE_MAX_KEYS
    if slots:
        assert math.ceil(beams * plan.gen_slots / 16) * 16 <= tda.DECODE_MAX_KEYS
    assert 1 <= plan.splits <= min(plan.chunks, tda.DECODE_MAX_SPLITS)
    assert list(inspect.signature(tda.decode_plan).parameters) == [
        "batch", "beams", "heads", "kv_heads", "head_dim", "prompt_slots", "gen_slots"]


# the plans at the serving shapes, as measured best on the H100 (PERF.md):
# (batch, generated slots) -> (prompt slots a chunk, prompt chunks, generated
# slots a chunk, generated chunks, splits)
SERVING_PLANS = {
    (8, 16): (48, 3, 8, 2, 5),  # the 16-token phases: 5 blocks a pair, 320 in all
    (8, 64): (80, 2, 16, 4, 6),  # the int8-weight phase, 64 tokens
    (48, 64): (80, 2, 16, 4, 3),  # batch 48: 6 chunks over 3 blocks a pair
}


@pytest.mark.parametrize("key", list(SERVING_PLANS), ids=["b8_L16", "b8_L64", "b48_L64"])
def test_decode_plan_at_the_serving_shapes(key):
    batch, slots = key
    plan = tda.decode_plan(batch, 5, 24, 8, 128, 130, slots)
    assert tuple(plan) == SERVING_PLANS[key]
    # fewer blocks than chunks only where the grid would pass the target
    assert plan.splits == plan.chunks or batch * 8 * (plan.splits - 1) < tda.DECODE_TARGET_BLOCKS


REFUSED = {
    "head_dim_64": (8, 5, 24, 8, 64, 130, 16),
    "heads_not_a_multiple": (8, 5, 24, 7, 128, 130, 16),
    "batch_65536": (65536, 5, 24, 8, 128, 130, 16),
    "no_slots": (8, 5, 24, 8, 128, 0, 0),
    "past_the_query_rows": (8, 2 ** 16 // 3 + 1, 24, 8, 128, 130, 16),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_decode_plan_refuses_what_the_kernel_cannot_take(name):
    with pytest.raises(ValueError, match="decode attention kernel"):
        tda.decode_plan(*REFUSED[name])


# wide beams at LLaMA-3.2-3B's rep 3 (24 query / 8 kv heads): 18 to 192
# query rows a kv head, in 16-row tiles, at batch 8 and 48, 16 and 64
# generated slots
WIDE_BEAMS = [6, 8, 16, 17, 64]


@pytest.mark.parametrize("beams", WIDE_BEAMS)
@pytest.mark.parametrize("batch, slots", [(8, 16), (48, 64)], ids=["b8_L16", "b48_L64"])
def test_decode_plan_takes_every_beam_width(beams, batch, slots):
    """More than 16 query rows a kv head is a plan like any other: every
    slot in one chunk, K x generated slots within 128 key rows, the block's
    shared memory within 227 KB; the plan is the one decode_plan gives the
    shapes, at every valid_len."""
    plan = tda.decode_plan(batch, beams, 24, 8, 128, 130, slots)
    for size, chunks, total in ((plan.prompt_slots, plan.prompt_chunks, 130),
                                (plan.gen_slots, plan.gen_chunks, slots)):
        assert size * chunks >= total > size * (chunks - 1)
    keys = max(plan.prompt_slots, math.ceil(beams * plan.gen_slots / 16) * 16)
    assert keys <= tda.DECODE_MAX_KEYS
    for kv_bytes, merged in ((1, True), (2, False)):
        assert tda.decode_smem_bytes(keys, kv_bytes, merged) <= tda.DECODE_SMEM_MAX
    assert 1 <= plan.splits <= min(plan.chunks, tda.DECODE_MAX_SPLITS)


def test_decode_plan_past_128_beams_takes_one_slot_a_chunk():
    """Past 128 beams a generated chunk is one slot of every source row
    (K key rows), up to the beams whose chunk fits 227 KB with bf16 KV."""
    most = tda.decode_max_beams()
    assert most >= 256
    for beams in (129, most):
        plan = tda.decode_plan(8, beams, 24, 8, 128, 130, 16)
        assert plan.gen_slots == 1 and plan.gen_chunks == 16
        assert tda.decode_smem_bytes(math.ceil(beams / 16) * 16, 2, False) <= tda.DECODE_SMEM_MAX
    assert tda.decode_smem_bytes(math.ceil((most + 1) / 16) * 16, 2, False) > tda.DECODE_SMEM_MAX


@pytest.mark.parametrize("beams", [337, 500, 4096])
@pytest.mark.parametrize("slots", [16, 64])
def test_decode_plan_past_336_beams_reads_slots_in_pieces(beams, slots):
    """Past ``decode_max_beams()`` a generated chunk is one slot of a piece
    of the source beams (``gen_chunk_beams``, a multiple of 16): every slot
    in ceil(beams / piece) chunks, each chunk's keys and the ancestors of
    every query beam within 227 KB in both KV types."""
    most = tda.decode_max_beams()
    assert most == 336 and tda.gen_chunk_beams(most) == most
    piece = tda.gen_chunk_beams(beams)
    pieces = math.ceil(beams / piece)
    assert piece % 16 == 0 and piece < beams and pieces >= 2
    assert piece * (pieces - 1) < beams <= piece * pieces
    plan = tda.decode_plan(8, beams, 24, 8, 128, 130, slots)
    assert plan.gen_slots == 1 and plan.gen_chunks == slots * pieces
    for kv_bytes, merged in ((2, False), (1, True)):
        assert tda.decode_smem_bytes(piece, kv_bytes, merged, beams) <= tda.DECODE_SMEM_MAX
    assert 1 <= plan.splits <= tda.DECODE_MAX_SPLITS


@pytest.mark.parametrize("beams", [5, 8])
@pytest.mark.parametrize("entry", ["prompt", "gen", "merged"])
def test_wrappers_launch_one_grid_for_every_valid_len(monkeypatch, entry, beams):
    """The kernel path (meta tensors, a recording stand-in for the library):
    the plan passed to the C entry is the same at every valid_len, and is
    decode_plan's for the shapes; at beam 5 (15 query rows a kv head, one
    tile) and beam 8 (24 rows, two)."""
    calls = []

    class Lib:
        def call(self, name, *args):
            calls.append((name, args))

    monkeypatch.setattr(kernel_lib, "load", lambda: Lib())
    monkeypatch.setattr(kernel_lib, "check", lambda *a, **kw: None)
    monkeypatch.setattr(kernel_lib, "stream_ptr", lambda t: 0)
    b, h, g, d, tp, slots = 8, 24, 8, 128, 130, 16
    meta = dict(device="meta")
    q = torch.empty(b * beams, h, d, dtype=torch.bfloat16, **meta)
    pk = torch.empty(b, g, tp, d, dtype=torch.int8, **meta)
    ps = torch.empty(b, g, tp, **meta)
    gk = torch.empty(b * beams, slots, g, d, dtype=torch.int8, **meta)
    gs = torch.empty(b * beams, slots, g, **meta)
    anc = torch.empty(b * beams, slots, dtype=torch.int32, **meta)
    mask = torch.empty(b, tp, dtype=torch.int32, **meta)
    for valid in (0, 1, slots):
        if entry == "prompt":
            tda.prompt_attention(q, pk, pk, mask, beams=beams, scale=0.1, k_scale=ps, v_scale=ps)
        elif entry == "gen":
            tda.gen_attention_ancestor(q, gk, gk, anc, valid, beams=beams, scale=0.1,
                                       k_scale=gs, v_scale=gs)
        else:
            tda.ancestry_attention(q, pk, pk, mask, gk, gk, anc, valid, beams=beams, scale=0.1,
                                   prompt_k_scale=ps, prompt_v_scale=ps, gen_k_scale=gs,
                                   gen_v_scale=gs, out_dtype=torch.bfloat16)
    plan = tda.decode_plan(b, beams, h, g, d, 0 if entry == "gen" else tp,
                           0 if entry == "prompt" else slots)
    want = {"prompt": (plan.prompt_slots, plan.prompt_chunks, plan.splits),
            "gen": (plan.gen_slots, plan.gen_chunks, plan.splits),
            "merged": (plan.prompt_slots, plan.prompt_chunks, plan.gen_slots, plan.gen_chunks,
                       plan.splits)}
    sent = []
    for name, args in calls:
        i = args.index(d, 9)  # the plan's integers follow the head dim
        sent.append(args[i + 1 : i + 1 + len(want[entry])])
    assert len(calls) == 3 and sent == [want[entry]] * 3


def _attention_and_cache(dtype, b=2, beams=3, tp=7, slots=5):
    """A tiny LLaMA attention layer and an int8 split cache for it, random
    from seed 5, with two generated slots written and a reordered ancestry."""
    torch.manual_seed(5)
    cfg = tl.LlamaConfig.tiny(vocab_size=64)
    attn = tl.LlamaAttention(cfg, dtype=dtype)
    g, d = cfg.num_kv_heads, cfg.head_dim
    pk, pks = tda.quantize_kv(torch.randn(b, g, tp, d))
    pv, pvs = tda.quantize_kv(torch.randn(b, g, tp, d))
    fk, fks = tda.quantize_kv(torch.randn(b * beams, slots, g, d))
    fv, fvs = tda.quantize_kv(torch.randn(b * beams, slots, g, d))
    mask = torch.ones(b, tp, dtype=torch.int32)
    mask[0, :3] = 0
    anc = torch.randint(0, beams, (b * beams, slots), dtype=torch.int32)
    cache = {"prompt_k": pk, "prompt_v": pv, "prompt_ks": pks, "prompt_vs": pvs,
             "prompt_mask": mask, "fixed_k": fk, "fixed_v": fv, "fixed_ks": fks,
             "fixed_vs": fvs, "anc": anc, "index": 2}
    return attn, cfg, cache


def _unfused_attention(q, prompt_k, prompt_v, prompt_mask, gen_k, gen_v, anc, valid_len, *, beams,
               scale, prompt_k_scale, prompt_v_scale, gen_k_scale, gen_v_scale, out_dtype):
    """The int8 ancestry attention as two partial calls, the merge, then the
    cast, as the decode step computed it before the merged entry."""
    out_p, m_p, l_p = tda.prompt_attention(q, prompt_k, prompt_v, prompt_mask, beams=beams,
                                           scale=scale, k_scale=prompt_k_scale,
                                           v_scale=prompt_v_scale)
    out_g, m_g, l_g = tda.gen_attention_ancestor(q, gen_k, gen_v, anc, valid_len, beams=beams,
                                                 scale=scale, k_scale=gen_k_scale,
                                                 v_scale=gen_v_scale)
    return tda.merge_softmax_segments(out_p, m_p, l_p, out_g, m_g, l_g).to(out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ancestry_step_int8_goes_through_the_merged_entry(monkeypatch, dtype):
    """``_ancestry_step`` with an int8 cache calls ``ancestry_attention``
    once, and never the PyTorch merge; its output and cache are bit for bit
    those of the two partial calls, the merge and the cast."""
    attn, cfg, cache = _attention_and_cache(dtype)
    rows = cache["anc"].shape[0]
    g = torch.Generator().manual_seed(6)
    q = torch.randn(rows, cfg.num_heads, 1, cfg.head_dim, generator=g).to(dtype)
    k, v = (torch.randn(rows, cfg.num_kv_heads, 1, cfg.head_dim, generator=g).to(dtype)
            for _ in range(2))
    want_cache = copy.deepcopy(cache)
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return tda.ancestry_attention(*args, **kw)

    def no_merge(*args, **kw):
        raise AssertionError("the PyTorch merge ran on the int8 path")

    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(tl, "ancestry_attention", counted)
            m.setattr(tl, "merge_softmax_segments", no_merge)
            got, got_cache = attn._ancestry_step(q, k, v, cache)
        with monkeypatch.context() as m:
            m.setattr(tl, "ancestry_attention", _unfused_attention)
            want, want_cache = attn._ancestry_step(q, k, v, want_cache)
    assert len(calls) == 1
    assert got.dtype == dtype and torch.equal(got, want)
    for key, x in want_cache.items():
        assert torch.equal(got_cache[key], x) if torch.is_tensor(x) else got_cache[key] == x
