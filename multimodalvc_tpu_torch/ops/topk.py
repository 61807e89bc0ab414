"""Beam-search candidate top-2K: K4 and K5.

Port of ``multimodalvc_tpu/ops/topk.py``.  Three entry points compute one
function, the first n of ``(scores[:, :, None] + log_softmax(logits))`` over
the flat [B, K*V] candidates:

- ``beam_topk_columns`` (K4) and ``beam_topk_from_logits`` (K5) from the raw
  unembed logits with per-row max and logsumexp, the normalise applied
  inside the kernel; given no statistics (``None``), the kernel computes
  them itself;
- ``beam_topk`` (K5) from log-probs [B, K, V] (f32 or bf16), with max =
  logsumexp = 0, so the kernel's ``((x - 0) - 0) + score`` is bit-identical
  to ``logp + score``.

For CUDA tensors they launch ``csrc/topk.cu``, one kernel template for K4
and K5 (the JAX package's V -> 8 fold and column blocks are TPU tiling),
once a call, on the plan ``topk_plan`` takes from the shapes (past the wide
instance, the select form: a radix select in a few launches); for CPU
tensors they run the plain version, a stable descending sort over the flat
candidates, which is the contract the kernel must meet bit for bit: values
``max(((x - m) - ls) + score, -2.9e38)`` in f32, ties broken by the lowest
flat index (as ``lax.top_k``).  Statistics the kernel computes are its own:
m is the exact row max, ls ``log(sum(exp(x - m)))`` summed in another order
than PyTorch's, a few ulps apart; ``stats_out`` returns them.
``beam_topk`` and ``beam_topk_from_logits`` are one TPU kernel and share one
launch counter, ``beam_topk.launches``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from . import kernel_lib

_CLAMP = -2.9e38  # inputs clamp here, as in the JAX package

# the kernel's limits and shared memory (csrc/topk.cu: THREADS, MAX_*, Smem)
TOPK_THREADS = 512
TOPK_WARPS = TOPK_THREADS // 32
TOPK_MAX_CLUSTER = 16  # blocks a cluster (above 8 the non-portable size)
TOPK_MAX_ROWS = 16  # beams a batch element of the narrow instances
TOPK_MAX_N = 32  # n of the narrow instances (one list entry a lane)
TOPK_WIDE_MAX_N = 256  # n of the wide instance (past 16 beams or n = 32)
TOPK_MAX_STAGES = 8  # chunks in the copy ring
TOPK_UNIT = 16  # bytes a thread copies a row and chunk
TOPK_SMEM_MAX = 232448  # 227 KB a block
# The cluster sizes topk_plan chooses from, with how many clusters of each an
# H100 SXM runs at once (cudaOccupancyMaxActiveClusters for the kernel, one
# block an SM, as ``chip_smoke.py --plans`` prints it on an H100 80GB HBM3).
TOPK_CLUSTERS_AT_ONCE = {16: 7, 8: 15, 4: 30, 2: 66}
# The wide instance takes a shape only where its block's shared memory fits a
# cluster of this size; past it, the select form.  The crossover measured on
# an H100 80GB HBM3 (``chip_smoke.py --plans``, TOPK_FORM_CASES, batch 8, n =
# 2K): on clusters of 8 (beams 17-100) the wide instance takes 0.35-0.49 of
# the select form's time; on clusters of 4 (beams 101-103) 0.76, 1.04 and
# 0.76; on a cluster of 2 (beam 104) 2.99.
TOPK_WIDE_MIN_CLUSTER = 4


class TopkPlan(NamedTuple):
    cluster: int  # blocks (one cluster) a batch element; the grid is (cluster, B)
    cols: int  # columns a block owns, a multiple of 8
    stages: int  # chunks of the copy ring; the whole range is staged if it holds all
    summary: int  # chunks that leave the ring and keep their unit maxima (0: none)


class SelectPlan(NamedTuple):
    """The select form (``csrc/topk.cu``, past the wide instance): a radix
    select over the candidates' order bits in a few launches."""

    blocks: int  # blocks a batch element, each a contiguous range of its K*V candidates


# the select form's grid: about 4 blocks an SM of an H100 SXM over the batch,
# each at least SELECT_MIN_RANGE candidates
SELECT_TARGET_BLOCKS, SELECT_MIN_RANGE = 4 * 132, 16384
SELECT_BINS = 2048  # the radix passes' histogram


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(b: int) -> int:
    return _cdiv(b, 16) * 16


def topk_wide(beams: int, n: int) -> bool:
    """Whether the shapes take the wide instance of the kernel (any beams,
    n <= 256, no ring), rather than a narrow one (<= 16 beams, n <= 32)."""
    return beams > TOPK_MAX_ROWS or n > TOPK_MAX_N


def topk_smem_bytes(beams: int, n: int, cluster: int, stages: int, summary_chunks: int = 0) -> int:
    """Shared memory of one block of the top-k kernel (``Smem`` in
    ``csrc/topk.cu``, which launches with its own count and refuses a plan
    that does not fit): statistics, partials, lists, merge buffers, the
    leader's gather, a copy ring of ``stages`` chunks of [beams, 512]
    16-byte units, and the f32 unit maxima of ``summary_chunks`` chunks.
    The wide instance has no ring and no unit maxima, ranks its block's
    n x beams keys itself and sends the leader n of them."""
    wide = topk_wide(beams, n)
    rows, sent = max(_cdiv(beams, 4) * 4, TOPK_MAX_ROWS), 1 if wide else beams
    merge = max(TOPK_WARPS * n, cluster * n * sent, n * beams if wide else 0)
    if wide:
        stages = summary_chunks = 0
    small = (5 * rows * 4 + TOPK_MAX_CLUSTER * rows * 4 + rows * 8
             + _align16(TOPK_WARPS * beams * 8) + _align16(cluster * beams * 8)
             + _align16(TOPK_WARPS * n * 8) + _align16(TOPK_WARPS * 8) + _align16(merge * 8)
             + _align16(cluster * 8) + _align16(n * 8) + 16 + _align16(cluster * n * sent * 8))
    return (small + stages * beams * TOPK_THREADS * TOPK_UNIT
            + summary_chunks * beams * TOPK_THREADS * 4)


def topk_chunks(cols: int, itemsize: int = 4) -> int:
    """Chunks a thread streams: 16-byte units of ``cols`` columns over 512 threads."""
    return _cdiv(_cdiv(cols, TOPK_UNIT // itemsize), TOPK_THREADS)


def topk_summary_chunks(beams: int, n: int, cluster: int, cols: int, stages: int,
                        itemsize: int = 4) -> int:
    """The chunks that leave a ring of ``stages`` and keep their unit maxima,
    where they fit beside it; else 0, and phase B streams them in again."""
    left = max(topk_chunks(cols, itemsize) - stages, 0)
    fits = topk_smem_bytes(beams, n, cluster, stages, left) <= TOPK_SMEM_MAX
    return left if left and fits else 0


def plan_for(vocab: int, beams: int, n: int, cluster: int, stages: Optional[int] = None,
             itemsize: int = 4) -> TopkPlan:
    """The plan with ``cluster`` blocks of equal column ranges (fewer where the
    last ones would own no column) and ``stages``, or the deepest ring beside
    which the chunks that leave it keep their unit maxima; where no ring
    allows that, the deepest that fits."""
    cols = _cdiv(_cdiv(vocab, cluster), 8) * 8
    cluster = _cdiv(vocab, cols)
    if stages is None:
        chunks = topk_chunks(cols, itemsize)
        fit = [s for s in range(1, min(TOPK_MAX_STAGES, chunks) + 1)
               if topk_smem_bytes(beams, n, cluster, s) <= TOPK_SMEM_MAX]
        summarized = [s for s in fit if s == chunks
                      or topk_summary_chunks(beams, n, cluster, cols, s, itemsize)]
        stages = max(summarized or fit or [1])
    return TopkPlan(cluster, cols, stages,
                    topk_summary_chunks(beams, n, cluster, cols, stages, itemsize))


def select_plan(batch: int, beams: int, vocab: int) -> SelectPlan:
    """The select form's grid for ``batch`` x ``beams`` rows of ``vocab``."""
    blocks = min(_cdiv(beams * vocab, SELECT_MIN_RANGE), _cdiv(SELECT_TARGET_BLOCKS, batch))
    return SelectPlan(max(blocks, 1))


def select_workspace_bytes(batch: int, beams: int, n: int, blocks: int) -> int:
    """The select form's zeroed workspace (``mmvc_beam_topk_select``): the
    row statistics, the n keys, the histograms, the state and the ties of
    each batch element."""
    return batch * (8 * beams + 8 * n + 4 * SELECT_BINS + 16 + 4 * blocks) + 16


@functools.lru_cache(maxsize=None)
def topk_plan(batch: int, beams: int, vocab: int, n: int,
              itemsize: int = 4) -> Union[TopkPlan, SelectPlan]:
    """The cluster size, columns a block and ring depth of the top-k kernel
    for ``batch`` x ``beams`` rows of ``vocab`` columns (``itemsize`` bytes
    each).  It depends on the shapes alone, never on the values, so one grid
    serves every step.

    ``plan_for``'s ring for the cluster size whose phase B reads no chunk
    twice (the whole range in the ring, or the others' unit maxima beside
    it), in the fewest waves of clusters the card runs at once, the largest
    such: at batch 8 and V = 128256, 8 blocks of 16032
    columns, 4 of a thread's 8 chunks in the ring and the unit maxima of the
    other 4.  More than 16 beams, or n > 32, take the wide instance where
    its block fits a cluster of TOPK_WIDE_MIN_CLUSTER (up to
    ``topk_max_beams()`` beams at n = 2 x beams, and n <= 256): no ring,
    the cluster size of the fewest waves, the largest such, whose shared
    memory fits; past it the select form, for any beams and n up to the
    candidates (``SelectPlan``).
    Raises ValueError for what the kernel cannot take."""
    why = None
    wide = topk_wide(beams, n)
    if batch <= 0 or batch > 65535:
        why = f"batch {batch}"
    elif beams <= 0:
        why = f"{beams} beams"
    elif vocab <= 0 or beams * vocab >= 2 ** 31:
        why = f"{beams} x {vocab} candidates"
    elif n <= 0 or n > beams * vocab:
        why = f"n = {n} (at most the candidates)"
    if why is not None:
        raise ValueError(f"beam top-k kernel: {why}")
    if wide and not _wide_fits(beams, n):
        return select_plan(batch, beams, vocab)
    if wide:
        return _wide_plan(batch, beams, vocab, n)
    plans = []
    for cluster, at_once in TOPK_CLUSTERS_AT_ONCE.items():
        plan = plan_for(vocab, beams, n, cluster, itemsize=itemsize)
        if topk_smem_bytes(beams, n, plan.cluster, plan.stages) > TOPK_SMEM_MAX:
            continue
        whole = plan.stages == topk_chunks(plan.cols, itemsize) or plan.summary > 0
        plans.append((not whole, _cdiv(batch, at_once), -cluster, plan))
    if not plans:
        raise ValueError(f"beam top-k kernel: {beams} beams and n = {n} leave no room for a ring")
    return min(plans)[-1]


def _wide_fits(beams: int, n: int) -> bool:
    """Whether the wide instance takes ``beams`` rows and ``n``: n <= 256 and
    its block's shared memory fits a cluster of TOPK_WIDE_MIN_CLUSTER."""
    return n <= TOPK_WIDE_MAX_N and topk_smem_bytes(
        beams, n, TOPK_WIDE_MIN_CLUSTER, 1) <= TOPK_SMEM_MAX


def _wide_plan(batch: int, beams: int, vocab: int, n: int) -> TopkPlan:
    plans = []
    for cluster, at_once in TOPK_CLUSTERS_AT_ONCE.items():
        cols = _cdiv(_cdiv(vocab, cluster), 8) * 8
        blocks = _cdiv(vocab, cols)
        if topk_smem_bytes(beams, n, blocks, 1) <= TOPK_SMEM_MAX:
            plans.append((_cdiv(batch, at_once), -blocks, TopkPlan(blocks, cols, 1, 0)))
    return min(plans)[-1]


@functools.lru_cache(maxsize=None)
def topk_max_beams() -> int:
    """The most beams the wide (cluster) instance takes with n = 2 x beams
    (the beam search's candidates), ``_wide_fits``'s limit.  Past it the
    select form takes every width."""
    beams = TOPK_MAX_ROWS
    while _wide_fits(beams + 1, 2 * (beams + 1)):
        beams += 1
    return beams


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics on the last axis: values descending, the
    lowest index first among equal values (``torch.topk`` promises no tie
    order, a stable descending sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def row_stats(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, logsumexp) of each row [R, 1], in f32, as the beam step computed
    them in PyTorch: ``log(sum(exp(x - max)))``."""
    lf = logits.float()
    row_max = lf.amax(dim=-1, keepdim=True)
    return row_max, torch.log(torch.exp(lf - row_max).sum(dim=-1, keepdim=True))


def _candidates(logits, row_max, row_logsumexp, scores) -> torch.Tensor:
    r = logits.shape[0]
    x = (logits.float() - row_max.reshape(r, 1).float()) - row_logsumexp.reshape(r, 1).float()
    x = x + scores.reshape(r, 1).float()
    return torch.clamp(x, min=_CLAMP)


def beam_topk_columns_plain(logits, row_max, row_logsumexp, scores, n, stats_out=None):
    """Plain version of K4 and of K5 from logits: the first n of a stable
    descending sort; ``None`` statistics are ``row_stats(logits)``."""
    b, k = scores.shape
    if row_max is None:
        row_max, row_logsumexp = row_stats(logits)
        if stats_out is not None:
            for dst, src in zip(stats_out, (row_max, row_logsumexp)):
                dst.copy_(src.reshape(dst.shape))
    x = _candidates(logits, row_max, row_logsumexp, scores).reshape(b, -1)
    vals, idx = top_k(x, n)
    return vals, idx.to(torch.int32)


beam_topk_from_logits_plain = beam_topk_columns_plain


def beam_topk_plain(logp, scores, n):
    """Plain version of K5 on log-probs [B, K, V]."""
    b, k, v = logp.shape
    x = torch.clamp(logp.float() + scores.reshape(b, k, 1).float(), min=_CLAMP)
    vals, idx = top_k(x.reshape(b, k * v), n)
    return vals, idx.to(torch.int32)


def _outputs(ref: torch.Tensor, b: int, n: int):
    return (torch.empty(b, n, dtype=torch.float32, device=ref.device),
            torch.empty(b, n, dtype=torch.int32, device=ref.device))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _from_logits(logits, row_max, row_logsumexp, scores, n, stats_out):
    """Check the operands of the from-logits entry and launch it."""
    b, k = scores.shape
    r, v = logits.shape
    if r != b * k:
        raise ValueError(f"beam top-k: logits {tuple(logits.shape)} vs scores {(b, k)}")
    if (row_max is None) != (row_logsumexp is None):
        raise ValueError("beam top-k: give both row_max and row_logsumexp, or neither")
    kernel_lib.check(logits, "logits", torch.float32, (r, v))
    kernel_lib.check(scores, "scores", torch.float32, (b, k))
    stats = row_max is None
    if not stats:
        row_max, row_logsumexp = row_max.reshape(r), row_logsumexp.reshape(r)
        kernel_lib.check(row_max, "row_max", torch.float32, (r,))
        kernel_lib.check(row_logsumexp, "row_logsumexp", torch.float32, (r,))
    m_out = ls_out = None
    if stats_out is not None:
        if not stats:
            raise ValueError("beam top-k: stats_out is for statistics the kernel computes")
        m_out, ls_out = stats_out
        kernel_lib.check(m_out, "stats_out[0]", torch.float32, (r,))
        kernel_lib.check(ls_out, "stats_out[1]", torch.float32, (r,))
    plan = topk_plan(b, k, v, n)
    out_v, out_f = _outputs(logits, b, n)
    if isinstance(plan, SelectPlan):
        _select(logits, 0, row_max, row_logsumexp, scores, m_out, ls_out, out_v, out_f, b, k, n,
                plan)
        return out_v, out_f
    kernel_lib.load().call(
        "mmvc_beam_topk_columns", logits.data_ptr(), _ptr(row_max), _ptr(row_logsumexp),
        scores.data_ptr(), _ptr(m_out), _ptr(ls_out), out_v.data_ptr(), out_f.data_ptr(), b, k,
        v, n, *plan, kernel_lib.stream_ptr(logits))
    return out_v, out_f


def _select(x, kind, row_max, row_logsumexp, scores, m_out, ls_out, out_v, out_f, b, k, n,
            plan: SelectPlan) -> None:
    """Launch the select form on its zeroed workspace (``kind``: 0 f32
    logits, 1 f32 log-probs, 2 bf16 log-probs)."""
    ws = torch.zeros(select_workspace_bytes(b, k, n, plan.blocks), dtype=torch.uint8,
                     device=x.device)
    kernel_lib.load().call(
        "mmvc_beam_topk_select", x.data_ptr(), kind, _ptr(row_max), _ptr(row_logsumexp),
        scores.data_ptr(), _ptr(m_out), _ptr(ls_out), out_v.data_ptr(), out_f.data_ptr(),
        ws.data_ptr(), b, k, x.shape[-1], n, plan.blocks, kernel_lib.stream_ptr(x))


def beam_topk_columns(
    logits: torch.Tensor,  # [B*K, V] raw logits straight from the unembed
    row_max: Optional[torch.Tensor],  # [B*K] or [B*K, 1] f32 per-row max(logits), or None
    row_logsumexp: Optional[torch.Tensor],  # [B*K] or [B*K, 1] f32 log(sum(exp(x - max)))
    scores: torch.Tensor,  # [B, K] f32 running beam scores
    n: int,
    stats_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # [B*K] f32 each
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, n] f32, flat indices [B, n] int32) of
    ``(scores[:, :, None] + log_softmax(logits).reshape(B, K, V)).reshape(B, K*V)``,
    with the normalise applied inside the kernel.  ``None`` statistics: the
    kernel computes them (the plain version: ``row_stats``), and writes them
    into ``stats_out`` if given.

    CUDA tensors run K4: f32 logits [B*K, V] and f32 row statistics."""
    if logits.device.type == "cpu":
        return beam_topk_columns_plain(logits, row_max, row_logsumexp, scores, n, stats_out)
    out = _from_logits(logits, row_max, row_logsumexp, scores, n, stats_out)
    beam_topk_columns.launches += 1
    return out


beam_topk_columns.launches = 0


def beam_topk_from_logits(
    logits: torch.Tensor,  # [B*K, V] raw logits, any V
    row_max: Optional[torch.Tensor],  # [B*K] or [B*K, 1] f32, or None
    row_logsumexp: Optional[torch.Tensor],  # [B*K] or [B*K, 1] f32, or None
    scores: torch.Tensor,  # [B, K] f32
    n: int,
    stats_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 from the raw logits: the contract of ``beam_topk_columns``, for a
    vocabulary with V % 8 != 0 (the JAX package's dispatch).  CUDA tensors
    launch the kernel and count in ``beam_topk.launches``."""
    if logits.device.type == "cpu":
        return beam_topk_from_logits_plain(logits, row_max, row_logsumexp, scores, n, stats_out)
    out = _from_logits(logits, row_max, row_logsumexp, scores, n, stats_out)
    beam_topk.launches += 1
    return out


def beam_topk(
    logp: torch.Tensor,  # [B, K, V] f32 or bf16 log-probs (+ any penalties)
    scores: torch.Tensor,  # [B, K] f32 running beam scores
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, n] f32, flat indices [B, n] int32) of
    ``(scores[:, :, None] + logp).reshape(B, K*V)``, without materialising
    the candidate row.  CUDA tensors run K5."""
    if logp.device.type == "cpu":
        return beam_topk_plain(logp, scores, n)
    b, k, v = logp.shape
    if logp.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"beam_topk: logp must be f32 or bf16, got {logp.dtype}")
    kernel_lib.check(logp, "logp", logp.dtype, (b, k, v))
    kernel_lib.check(scores, "scores", torch.float32, (b, k))
    plan = topk_plan(b, k, v, n, logp.element_size())
    out_v, out_f = _outputs(logp, b, n)
    if isinstance(plan, SelectPlan):
        _select(logp, 2 if logp.dtype == torch.bfloat16 else 1, None, None, scores, None, None,
                out_v, out_f, b, k, n, plan)
        beam_topk.launches += 1
        return out_v, out_f
    kernel_lib.load().call(
        "mmvc_beam_topk", logp.data_ptr(), int(logp.dtype == torch.bfloat16), scores.data_ptr(),
        out_v.data_ptr(), out_f.data_ptr(), b, k, v, n, *plan, kernel_lib.stream_ptr(logp))
    beam_topk.launches += 1
    return out_v, out_f


beam_topk.launches = 0
