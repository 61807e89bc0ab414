"""Attention primitives: the plain PyTorch path and the K1 flash kernel.

Port of ``multimodalvc_tpu/ops/attention.py``.  ``flash_attention`` keeps the
JAX signature and masking contract; for CUDA tensors it launches the
hand-written Hopper kernel ``csrc/flash_attention.cu`` and for CPU tensors
it runs ``_windowed_reference_attention``, its plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import kernel_lib

NEG_INF = -1e30


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention. q: [B,H,Tq,D], k/v: [B,H,Tk,D].

    mask: broadcastable to [B,H,Tq,Tk]; True = attend. bias: additive.
    Softmax in f32 regardless of the input dtype.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        tq, tk = scores.shape[-2:]
        cmask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        scores = torch.where(cmask, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _windowed_reference_attention(q, k, v, kv_lens, kv_starts, causal, scale):
    """Plain version of K1: valid columns are [kv_starts, kv_lens), causal
    means col <= row, and fully masked rows give exact zeros."""
    tq, tk = q.shape[2], k.shape[2]
    col = torch.arange(tk, device=q.device)[None, None, None, :]
    mask = (col >= kv_starts[:, None, None, None]) & (col < kv_lens[:, None, None, None])
    if causal:
        row = torch.arange(tq, device=q.device)[None, None, :, None]
        mask = mask & (col <= row)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = torch.where(mask, s * scale, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _defaults(q, k, kv_lens, scale, kv_starts):
    b, tk = q.shape[0], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kv_lens is None:
        kv_lens = torch.full((b,), tk, dtype=torch.int32, device=q.device)
    if kv_starts is None:
        kv_starts = torch.zeros((b,), dtype=torch.int32, device=q.device)
    return scale, kv_lens.to(torch.int32), kv_starts.to(torch.int32)


def flash_attention_plain(q, k, v, kv_lens=None, causal=False, scale=None, kv_starts=None):
    """Plain version of K1, with ``flash_attention``'s signature."""
    scale, kv_lens, kv_starts = _defaults(q, k, kv_lens, scale, kv_starts)
    return _windowed_reference_attention(q, k, v, kv_lens, kv_starts, causal, scale)


def fold_scale(q: torch.Tensor, scale: float):
    """(q', scale') with scale' > 0 and q'.k * scale' == q.k * scale exactly,
    for the K1 kernel, which takes its running max on the unscaled scores:
    a negative scale moves its sign into q (negation is exact in bf16), and
    a zero scale becomes zero q with scale 1 (every valid score 0, so the
    softmax is uniform over the valid keys, as in the JAX kernel).  A NaN
    passes through, for the kernel's entry to refuse."""
    if scale < 0:
        return -q, -scale
    if scale == 0:
        return torch.zeros_like(q), 1.0
    return q, scale


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash attention. q: [B,H,Tq,D], k/v: [B,H,Tk,D], kv_lens/kv_starts: [B].

    The valid key window of batch row b is [kv_starts[b], kv_lens[b])
    (defaults: the whole Tk); ``causal`` adds col <= row.  A row with no
    valid key returns exact zeros.  The default scale is 1/sqrt(D); any
    scale is accepted (``fold_scale`` hands the kernel a positive one).

    CUDA tensors run the K1 kernel: bf16 q/k/v, contiguous, D in {64, 128}.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lens, causal, scale, kv_starts)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale, kv_lens, kv_starts = _defaults(q, k, kv_lens, scale, kv_starts)
    if d not in (64, 128):
        raise ValueError(f"flash_attention kernel: head dim {d} not in (64, 128)")
    for name, t, shape in (("q", q, (b, h, tq, d)), ("k", k, (b, h, tk, d)), ("v", v, (b, h, tk, d))):
        kernel_lib.check(t, name, torch.bfloat16, shape)
    kernel_lib.check(kv_lens, "kv_lens", torch.int32, (b,))
    kernel_lib.check(kv_starts, "kv_starts", torch.int32, (b,))
    q, scale = fold_scale(q, scale)
    out = torch.empty_like(q)
    kernel_lib.load().call(
        "mmvc_flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_lens.data_ptr(), kv_starts.data_ptr(), out.data_ptr(),
        b, h, tq, tk, d, int(causal), float(scale), kernel_lib.stream_ptr(q),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
