"""Lightweight and dynamic convolution (Wu et al., ICLR'19) over [B, T, C].

Port of ``multimodalvc_tpu/ops/dynamic_conv.py``: each op is one einsum
over a shifted stack of the input.  Kernel size K, H heads with C % H == 0;
the weights are softmax-normalised over K in f32 and cast to the input's
type.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def shifted_stack(x: torch.Tensor, kernel_size: int, padding_left: int) -> torch.Tensor:
    """[B, T, C] -> [B, T, K, C]; entry k holds x at t + k - padding_left
    (zero outside)."""
    t = x.shape[1]
    pad_r = kernel_size - 1 - padding_left
    xp = F.pad(x, (0, 0, padding_left, max(pad_r, 0)))
    return torch.stack([xp[:, k : k + t] for k in range(kernel_size)], dim=2)


def _normalised(weights: torch.Tensor, softmax: bool, dtype: torch.dtype) -> torch.Tensor:
    if softmax:
        return torch.softmax(weights.float(), dim=-1).to(dtype)
    return weights


def _stack(x, h, k, padding_left):
    b, t, c = x.shape
    if c % h:
        raise ValueError(f"channels {c} not divisible by heads {h}")
    if padding_left is None:
        padding_left = k - 1  # causal (decoder) default
    return shifted_stack(x, k, padding_left).reshape(b, t, k, h, c // h)


def lightweight_conv(x: torch.Tensor, weights: torch.Tensor,
                     padding_left: Optional[int] = None, softmax: bool = True) -> torch.Tensor:
    """LightConv: a per-head depthwise conv with tied weights [H, K], shared
    across positions and the batch."""
    b, t, c = x.shape
    h, k = weights.shape
    stack = _stack(x, h, k, padding_left)
    return torch.einsum("btkhd,hk->bthd", stack,
                        _normalised(weights, softmax, x.dtype)).reshape(b, t, c)


def dynamic_conv(x: torch.Tensor, weights: torch.Tensor,
                 padding_left: Optional[int] = None, softmax: bool = True) -> torch.Tensor:
    """DynamicConv: per-head conv weights [B, T, H, K] predicted per position."""
    b, t, c = x.shape
    h, k = weights.shape[2:]
    stack = _stack(x, h, k, padding_left)
    return torch.einsum("btkhd,bthk->bthd", stack,
                        _normalised(weights, softmax, x.dtype)).reshape(b, t, c)
