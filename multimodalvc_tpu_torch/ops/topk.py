"""Beam-search candidate top-2K: K4 and K5.

Port of ``multimodalvc_tpu/ops/topk.py``.  Three entry points compute one
function, the first n of ``(scores[:, :, None] + log_softmax(logits))`` over
the flat [B, K*V] candidates:

- ``beam_topk_columns`` (K4) and ``beam_topk_from_logits`` (K5) from the raw
  unembed logits with per-row max and logsumexp, the normalise applied
  inside the kernel;
- ``beam_topk`` (K5) from log-probs [B, K, V] (f32 or bf16), with max =
  logsumexp = 0, so the kernel's ``((x - 0) - 0) + score`` is bit-identical
  to ``logp + score``.

For CUDA tensors they launch ``csrc/topk.cu`` (one kernel family for K4 and
K5: the JAX package's V -> 8 fold and column blocks are TPU tiling); for CPU
tensors they run the plain version, a stable descending sort over the flat
candidates, which is the contract the kernel must meet bit for bit: values
``max(((x - m) - ls) + score, -2.9e38)`` in f32, ties broken by the lowest
flat index (as ``lax.top_k``).  ``beam_topk`` and ``beam_topk_from_logits``
are one TPU kernel and share one launch counter, ``beam_topk.launches``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import kernel_lib

_CLAMP = -2.9e38  # inputs clamp here, as in the JAX package


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics on the last axis: values descending, the
    lowest index first among equal values (``torch.topk`` promises no tie
    order, a stable descending sort does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def _candidates(logits, row_max, row_logsumexp, scores) -> torch.Tensor:
    r = logits.shape[0]
    x = (logits.float() - row_max.reshape(r, 1).float()) - row_logsumexp.reshape(r, 1).float()
    x = x + scores.reshape(r, 1).float()
    return torch.clamp(x, min=_CLAMP)


def beam_topk_columns_plain(logits, row_max, row_logsumexp, scores, n):
    """Plain version of K4 and of K5 from logits: the first n of a stable
    descending sort."""
    b, k = scores.shape
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


def _launch(entry: str, inputs: tuple, ref: torch.Tensor, b: int, k: int, v: int, n: int):
    """Run one C entry of ``csrc/topk.cu`` with its [B, chunks, n] scratch;
    returns (values [B, n] f32, flat indices [B, n] int32)."""
    lib = kernel_lib.load()
    chunks = -(-v // lib.topk_chunk_columns)
    dev = ref.device
    cand_v = torch.empty(b, chunks, n, dtype=torch.float32, device=dev)
    cand_f = torch.empty(b, chunks, n, dtype=torch.int32, device=dev)
    out_v = torch.empty(b, n, dtype=torch.float32, device=dev)
    out_f = torch.empty(b, n, dtype=torch.int32, device=dev)
    lib.call(entry, *inputs, cand_v.data_ptr(), cand_f.data_ptr(), out_v.data_ptr(),
             out_f.data_ptr(), b, k, v, n, kernel_lib.stream_ptr(ref))
    return out_v, out_f


def _from_logits(logits, row_max, row_logsumexp, scores, n):
    """Check the operands of the from-logits entry and launch it."""
    b, k = scores.shape
    r, v = logits.shape
    if r != b * k:
        raise ValueError(f"beam top-k: logits {tuple(logits.shape)} vs scores {(b, k)}")
    row_max = row_max.reshape(r)
    row_logsumexp = row_logsumexp.reshape(r)
    kernel_lib.check(logits, "logits", torch.float32, (r, v))
    kernel_lib.check(row_max, "row_max", torch.float32, (r,))
    kernel_lib.check(row_logsumexp, "row_logsumexp", torch.float32, (r,))
    kernel_lib.check(scores, "scores", torch.float32, (b, k))
    return _launch("mmvc_beam_topk_columns", (logits.data_ptr(), row_max.data_ptr(),
                   row_logsumexp.data_ptr(), scores.data_ptr()), logits, b, k, v, n)


def beam_topk_columns(
    logits: torch.Tensor,  # [B*K, V] raw logits straight from the unembed
    row_max: torch.Tensor,  # [B*K] or [B*K, 1] f32 per-row max(logits)
    row_logsumexp: torch.Tensor,  # [B*K] or [B*K, 1] f32 log(sum(exp(x - max)))
    scores: torch.Tensor,  # [B, K] f32 running beam scores
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, n] f32, flat indices [B, n] int32) of
    ``(scores[:, :, None] + log_softmax(logits).reshape(B, K, V)).reshape(B, K*V)``,
    with the normalise applied inside the kernel.

    CUDA tensors run K4: f32 logits [B*K, V] and f32 row statistics."""
    if logits.device.type == "cpu":
        return beam_topk_columns_plain(logits, row_max, row_logsumexp, scores, n)
    out = _from_logits(logits, row_max, row_logsumexp, scores, n)
    beam_topk_columns.launches += 1
    return out


beam_topk_columns.launches = 0


def beam_topk_from_logits(
    logits: torch.Tensor,  # [B*K, V] raw logits, any V
    row_max: torch.Tensor,  # [B*K] or [B*K, 1] f32
    row_logsumexp: torch.Tensor,  # [B*K] or [B*K, 1] f32
    scores: torch.Tensor,  # [B, K] f32
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 from the raw logits: the contract of ``beam_topk_columns``, for a
    vocabulary with V % 8 != 0 (the JAX package's dispatch).  CUDA tensors
    launch the kernel and count in ``beam_topk.launches``."""
    if logits.device.type == "cpu":
        return beam_topk_from_logits_plain(logits, row_max, row_logsumexp, scores, n)
    out = _from_logits(logits, row_max, row_logsumexp, scores, n)
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
    out = _launch("mmvc_beam_topk", (logp.data_ptr(), int(logp.dtype == torch.bfloat16),
                  scores.data_ptr()), logp, b, k, v, n)
    beam_topk.launches += 1
    return out


beam_topk.launches = 0
