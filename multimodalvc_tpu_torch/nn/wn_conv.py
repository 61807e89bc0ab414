"""Weight-normalized 1-D convolutions, over [B, C, T].

Port of ``multimodalvc_tpu/nn/wn_conv.py`` (the generator's half):
W = g * v / ||v||, the norm over every dim but torch's dim 0 and floored at
1e-12, computed in f32 from the stored (v, g) at every call.  The
parameters keep torch's layouts: ``WNConv1d``'s v is [O, I/groups, K]
with g [O]; ``WNConvTranspose1d``'s v is [I, O, K] with g [I] (the norm
runs over the input channel, as torch's weight_norm on ConvTranspose1d).
The weight bridge moves the flax leaves ([K, I/g, O] and [K, O, I]) into
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / max(||v||, 1e-12), the norm over every dim but 0, in f32."""
    v32 = v.float()
    norm = v32.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return g.float().reshape(-1, *([1] * (v.ndim - 1))) * v32 / norm.clamp_min(1e-12)


class _WNConv(nn.Module):
    def __init__(self, v_shape, g_size: int, out_channels: int, bias: bool, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.v = nn.Parameter(torch.zeros(v_shape, **kw))
        self.g = nn.Parameter(torch.ones(g_size, **kw))
        self.bias = nn.Parameter(torch.zeros(out_channels, **kw)) if bias else None

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        return weight_norm_kernel(self.v, self.g).to(dtype)

    @torch.no_grad()
    def reset_g(self) -> None:
        """g = ||v||, so that W == v (torch's weight_norm at its creation)."""
        self.g.copy_(self.v.float().flatten(1).norm(dim=1))


class WNConv1d(_WNConv):
    """Weight-normalized Conv1d, torch padding semantics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, bias: bool = True,
                 device=None, dtype=None):
        super().__init__((out_channels, in_channels // groups, kernel_size), out_channels,
                         out_channels, bias, device, dtype)
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups

    def forward(self, x):
        return F.conv1d(x, self.weight(x.dtype), self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


class WNConvTranspose1d(_WNConv):
    """Weight-normalized ConvTranspose1d: output length (T - 1) * stride -
    2 * padding + kernel_size."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 padding: int = 0, bias: bool = True, device=None, dtype=None):
        super().__init__((in_channels, out_channels, kernel_size), in_channels, out_channels,
                         bias, device, dtype)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv_transpose1d(x, self.weight(x.dtype), self.bias, self.stride, self.padding)


def reset_weight_norm_(module: nn.Module) -> None:
    """Set every weight-normalized conv's g to ||v|| (after a random draw of v)."""
    for m in module.modules():
        if isinstance(m, _WNConv):
            m.reset_g()
