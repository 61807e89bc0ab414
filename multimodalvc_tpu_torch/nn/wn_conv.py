"""Weight-normalized and spectral-normalized convolutions, over [B, C, T]
and [B, C, H, W].

Port of ``multimodalvc_tpu/nn/wn_conv.py``: W = g * v / ||v||, the norm
over every dim but torch's dim 0 and floored at 1e-12, computed in f32 from
the stored (v, g) at every call.  The parameters keep torch's layouts:
``WNConv1d``'s v is [O, I/groups, K] with g [O]; ``WNConvTranspose1d``'s v
is [I, O, K] with g [I] (the norm runs over the input channel, as torch's
weight_norm on ConvTranspose1d); ``WNConv2d``'s v is [O, I, kH, kW] with g
[O].  The weight bridge moves the flax leaves ([K, I/g, O], [K, O, I] and
[kH, kW, I, O]) into them.

``SNConv1d`` is the JAX spectral norm, which is torch-like but not
``torch.nn.utils.spectral_norm``: W / sigma with sigma = u^T W_mat v, not
made positive; one power iteration (the JAX default, its only use) runs
only in a pass with ``update_sn`` (the discriminator's real pass in
training), which stores u and v; other passes use the stored vectors.  u and v are buffers (``sn_u`` [O],
``sn_v`` [I/g * K], the JAX "spectral" collection).  W_mat is v viewed as
[O, I/g * K] in torch's order, so ``sn_v`` runs over (I/g, K), as a torch
checkpoint's ``weight_v``; the JAX module flattens (K, I/g), and the bridge
reorders it.
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


class WNConv2d(_WNConv):
    """Weight-normalized Conv2d over [B, C, H, W] (the period discriminator's
    (k, 1) kernels), torch padding semantics."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), bias: bool = True, device=None, dtype=None):
        super().__init__((out_channels, in_channels, *kernel_size), out_channels, out_channels,
                         bias, device, dtype)
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, x):
        return F.conv2d(x, self.weight(x.dtype), self.bias, self.stride, self.padding)


class SNConv1d(nn.Module):
    """Spectral-normalized Conv1d (the first scale discriminator's convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.v = nn.Parameter(torch.zeros(out_channels, in_channels // groups, kernel_size, **kw))
        self.bias = nn.Parameter(torch.zeros(out_channels, **kw)) if bias else None
        f32 = dict(device=device, dtype=torch.float32)
        self.register_buffer("sn_u", torch.zeros(out_channels, **f32))
        self.register_buffer("sn_v", torch.zeros(kernel_size * in_channels // groups, **f32))
        self.stride, self.padding, self.groups = stride, padding, groups

    @torch.no_grad()
    def reset_spectral_(self, generator: torch.Generator) -> None:
        """u, v ~ N(0, 1) / sqrt(size), as the JAX module draws them."""
        for buf in (self.sn_u, self.sn_v):
            buf.normal_(generator=generator).div_(buf.numel() ** 0.5)

    def forward(self, x, update_sn: bool = False):
        w = self.v.float()
        w_mat = w.reshape(w.shape[0], -1)
        if update_sn:
            with torch.no_grad():
                v = w_mat.T @ self.sn_u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
                u = w_mat @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
                self.sn_u.copy_(u)
                self.sn_v.copy_(v)
        sigma = (self.sn_u @ w_mat) @ self.sn_v  # may be negative while unconverged
        return F.conv1d(x, (w / sigma).to(x.dtype), self.bias, self.stride, self.padding,
                        groups=self.groups)


def avg_pool_1d(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """torch AvgPool1d with count_include_pad=True over [B, T, C]."""
    return F.avg_pool1d(x.transpose(1, 2), window, stride, padding,
                        count_include_pad=True).transpose(1, 2)


def reset_weight_norm_(module: nn.Module) -> None:
    """Set every weight-normalized conv's g to ||v|| (after a random draw of v)."""
    for m in module.modules():
        if isinstance(m, _WNConv):
            m.reset_g()
