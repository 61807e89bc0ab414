"""HiFi-GAN generator: mel (or discrete units) -> waveform.

Port of the generator half of ``multimodalvc_tpu/nn/hifigan.py``: conv_pre,
the upsampling chain (10 * 4 * 2 * 2 = 160 with kernels 20 / 8 / 4 / 4),
after each upsampling the mean of the multi-receptive-field ResBlocks,
then a leaky ReLU at slope 0.01, conv_post and tanh.  The convs are
weight-normalized (``nn/wn_conv.py``) and run over [B, C, T] (cuDNN's
layout); the generator takes [B, T, C] and returns [B, T * 160, 1] as the
JAX module does.

``lengths`` ([B] valid input frames) zeroes every conv's input past each
row's frames, the count growing by each upsampling factor, so a static
padded buffer gives what an exact-length row would.  The discriminators
and the GAN losses are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import add_layers
from .wn_conv import WNConv1d, WNConvTranspose1d

LRELU_SLOPE = 0.1


def leaky_relu(x):
    return F.leaky_relu(x, LRELU_SLOPE)


@dataclass
class HifiGanConfig:
    in_channels: int = 128
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_factors: Tuple[int, ...] = (10, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (20, 8, 4, 4)
    upsample_initial_channel: int = 512
    # unit-LUT mode (discrete units -> embedding); None = mel input
    unit_nums: Optional[int] = None


def _get_padding(k: int, d: int) -> int:
    return (k * d - d) // 2


def _masked(h: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return h if mask is None else h * mask.to(h.dtype)


def _time_mask(lengths: Optional[torch.Tensor], t: int, device) -> Optional[torch.Tensor]:
    """[B] lengths -> [B, 1, t] bool over the time axis of [B, C, t], or None."""
    if lengths is None:
        return None
    return torch.arange(t, device=device)[None, None, :] < lengths[:, None, None]


class ResBlock(nn.Module):
    """MRF residual block: a dilated and a plain conv a dilation, each after a
    leaky ReLU, their input zeroed past the valid frames (``mask``)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...],
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        for i, d in enumerate(dilations):
            self.add_module(f"convs1_{i}", WNConv1d(channels, channels, kernel_size,
                                                    padding=_get_padding(kernel_size, d),
                                                    dilation=d, **kw))
            self.add_module(f"convs2_{i}", WNConv1d(channels, channels, kernel_size,
                                                    padding=_get_padding(kernel_size, 1), **kw))
        self.n = len(dilations)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        for i in range(self.n):
            h = getattr(self, f"convs1_{i}")(_masked(leaky_relu(x), mask))
            x = x + getattr(self, f"convs2_{i}")(_masked(leaky_relu(h), mask))
        return x


class HifiGanGenerator(nn.Module):
    """Mel [B, T, in_channels] (or units [B, T] int with ``unit_nums``) ->
    waveform [B, T * prod(upsample_factors), 1]."""

    def __init__(self, config: HifiGanConfig = None, device=None, dtype=None):
        super().__init__()
        cfg = self.cfg = config or HifiGanConfig()
        kw = dict(device=device, dtype=dtype)
        if cfg.unit_nums is not None:
            self.lut = nn.Parameter(torch.zeros(cfg.unit_nums + 1, cfg.in_channels, **kw))
        ch = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.in_channels, ch, 7, padding=3, **kw)
        resblocks = []
        for i, (u, k) in enumerate(zip(cfg.upsample_factors, cfg.upsample_kernel_sizes)):
            ch = cfg.upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"ups_{i}", WNConvTranspose1d(2 * ch, ch, k, stride=u,
                                                          padding=(k - u) // 2, **kw))
            resblocks += [ResBlock(ch, rk, rd, **kw) for rk, rd in
                          zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations)]
        self.resblocks = add_layers(self, resblocks, prefix="resblocks")
        self.conv_post = WNConv1d(ch, 1, 7, padding=3, **kw)

    def forward(self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if cfg.unit_nums is not None and not torch.is_floating_point(x):
            x = self.lut[x.long()]
        x = x.transpose(1, 2)  # [B, C, T]
        cur_len = lengths
        x = self.conv_pre(_masked(x, _time_mask(cur_len, x.shape[-1], x.device)))
        nk = len(cfg.resblock_kernel_sizes)
        for i, u in enumerate(cfg.upsample_factors):
            x = _masked(leaky_relu(x), _time_mask(cur_len, x.shape[-1], x.device))
            x = getattr(self, f"ups_{i}")(x)
            cur_len = None if cur_len is None else cur_len * u
            mask = _time_mask(cur_len, x.shape[-1], x.device)
            acc = None
            for block in self.resblocks[i * nk:(i + 1) * nk]:
                z = block(x, mask)
                acc = z if acc is None else acc + z
            x = acc / nk
        x = _masked(F.leaky_relu(x, 0.01), _time_mask(cur_len, x.shape[-1], x.device))
        return torch.tanh(self.conv_post(x)).transpose(1, 2)
