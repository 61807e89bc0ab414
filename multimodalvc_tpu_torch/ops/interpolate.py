"""Vectorized, static-shape time resampling.

Port of ``multimodalvc_tpu/ops/interpolate.py``: every sample is linearly
resized from its own source length to its own target length inside fixed
[B, T_out] buffers, positions past the target length zeroed.

The two gathers of the forward would take their gradient by a scatter-add,
which sums the ~T_out / T_in output rows of one source row with atomics on
CUDA, in an order that changes from run to run; ``_Lerp`` takes it as a
product with the dense interpolation weights instead, so that a training
step repeats itself bit for bit.
"""
from __future__ import annotations

import torch


class _Lerp(torch.autograd.Function):
    """``x[lo] * (1 - frac) + x[hi] * frac`` along time (x [B, T_in, D];
    lo, hi [B, T_out] int64; frac [B, T_out, 1] in x's type), as two gathers;
    the backward is W^T @ g with W [B, T_out, T_in] the weights of each
    output row's two source rows, in f32, cast to x's type."""

    @staticmethod
    def forward(ctx, x, lo, hi, frac):
        ctx.save_for_backward(lo, hi, frac)
        ctx.t_in = x.shape[1]
        d = x.shape[2]
        x_lo = torch.gather(x, 1, lo[..., None].expand(-1, -1, d))
        x_hi = torch.gather(x, 1, hi[..., None].expand(-1, -1, d))
        return x_lo * (1.0 - frac) + x_hi * frac

    @staticmethod
    def backward(ctx, g):
        lo, hi, frac = ctx.saved_tensors
        cols = torch.arange(ctx.t_in, device=g.device)
        w = ((lo[..., None] == cols) * (1.0 - frac).float()
             + (hi[..., None] == cols) * frac.float())
        return torch.bmm(w.transpose(1, 2), g.float()).to(g.dtype), None, None, None


def linear_resize_batched(
    x: torch.Tensor,  # [B, T_in, D], valid up to src_len[i]
    src_len: torch.Tensor,  # [B] int (>= 1)
    tgt_len: torch.Tensor,  # [B] int (>= 1, <= t_out)
    t_out: int,
    align_corners: bool = False,
) -> torch.Tensor:
    """Per-sample 1-D linear resize along time -> [B, t_out, D]."""
    _, t_in, _ = x.shape
    dev = x.device
    src = src_len.float()
    tgt = tgt_len.float()
    t = torch.arange(t_out, dtype=torch.float32, device=dev)[None, :]
    if align_corners:
        scale = torch.where(tgt > 1, (src - 1) / torch.clamp(tgt - 1, min=1), 0.0)
        pos = t * scale[:, None]
    else:
        scale = src / tgt
        pos = (t + 0.5) * scale[:, None] - 0.5
    pos = torch.minimum(torch.clamp(pos, min=0.0), src[:, None] - 1.0)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.minimum(lo + 1, (src[:, None] - 1).to(torch.int32))
    frac = (pos - lo.float())[..., None].to(x.dtype)
    out = _Lerp.apply(x, lo.clamp(0, t_in - 1).long(), hi.clamp(0, t_in - 1).long(), frac)
    valid = (torch.arange(t_out, device=dev)[None, :] < tgt_len[:, None])[..., None]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev))


def length_mask(lengths: torch.Tensor, max_len: int, dtype=torch.bool) -> torch.Tensor:
    """[B] lengths -> [B, max_len] mask (True = valid)."""
    return (torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)
