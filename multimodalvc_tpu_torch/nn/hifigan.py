"""HiFi-GAN: the generator (mel or discrete units -> waveform), the period
and scale discriminators, the GAN losses and the torch checkpoint import.

Port of ``multimodalvc_tpu/nn/hifigan.py``.  The generator: conv_pre,
the upsampling chain (10 * 4 * 2 * 2 = 160 with kernels 20 / 8 / 4 / 4),
after each upsampling the mean of the multi-receptive-field ResBlocks,
then a leaky ReLU at slope 0.01, conv_post and tanh.  The convs are
weight-normalized (``nn/wn_conv.py``) and run over [B, C, T] (cuDNN's
layout); the generator takes [B, T, C] and returns [B, T * 160, 1] as the
JAX module does.

``lengths`` ([B] valid input frames) zeroes every conv's input past each
row's frames, the count growing by each upsampling factor, so a static
padded buffer gives what an exact-length row would.

The discriminators take the waveform [B, T, 1], as the JAX ones do, and
run over [B, 1, T] (the scale discriminators) and [B, 1, T / p, p] (the
period discriminators: a reflect pad up to a multiple of p first); their
feature maps are in those layouts (the JAX ones are channels-last).
``HifiGanDiscriminator`` is the MPD over ``periods`` then ``n_scales``
scale discriminators, spectral norm on the first (``SNConv1d``; ``update_sn``
runs its power iteration), ``avg_pool_1d(4, 2, 2)`` between scales;
``channels_cap`` caps every width (1024 = the reference's).  The losses
are the LS-GAN ones.  ``import_torch_generator`` and
``import_torch_discriminator`` map a reference (soft-vc) state dict's
``weight_v`` / ``weight_g`` (and ``weight_orig`` / ``weight_u`` /
``weight_v`` of the spectral-normalized convs) onto this port's names;
the layouts are already torch's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import add_layers
from .wn_conv import SNConv1d, WNConv1d, WNConv2d, WNConvTranspose1d, avg_pool_1d

LRELU_SLOPE = 0.1


class _LeakyReLU(torch.autograd.Function):
    """``F.leaky_relu`` whose derivative at 0 is 1, as the JAX one's
    (``jnp.where(x >= 0, x, slope * x)``); torch's takes the slope there.
    Exact zeros are common in training: masked frames, and the zero-bias
    convs of a fresh discriminator over them."""

    @staticmethod
    def forward(ctx, x, slope):
        ctx.save_for_backward(x)
        ctx.slope = slope
        return F.leaky_relu(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, g * ctx.slope), None


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return _LeakyReLU.apply(x, slope)


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
        x = _masked(leaky_relu(x, 0.01), _time_mask(cur_len, x.shape[-1], x.device))
        return torch.tanh(self.conv_post(x)).transpose(1, 2)


class PeriodDiscriminator(nn.Module):
    """x [B, T, 1] -> (score [B, N], feature maps [B, C, T / p / ..., p])."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 channels_cap: int = 1024, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.period = period
        chans = [min(c, channels_cap) for c in (32, 128, 512, 1024)]
        pad = _get_padding(5, 1)
        convs, in_ch = [], 1
        for ch in chans:
            convs.append(WNConv2d(in_ch, ch, (kernel_size, 1), (stride, 1), (pad, 0), **kw))
            in_ch = ch
        convs.append(WNConv2d(in_ch, min(1024, channels_cap), (kernel_size, 1), padding=(2, 0),
                              **kw))
        self.convs = add_layers(self, convs, prefix="convs")
        self.conv_post = WNConv2d(min(1024, channels_cap), 1, (3, 1), padding=(1, 0), **kw)

    def forward(self, x):
        x = x.transpose(1, 2)  # [B, 1, T]
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
        x = x.reshape(b, c, -1, self.period)
        feats = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return x.flatten(1), feats


# (out channels, kernel, stride, padding, groups) of the scale discriminator
SCALE_SPECS = ((128, 15, 1, 7, 1), (128, 41, 2, 20, 4), (256, 41, 2, 20, 16),
               (512, 41, 4, 20, 16), (1024, 41, 4, 20, 16), (1024, 41, 1, 20, 16),
               (1024, 5, 1, 2, 1))


class ScaleDiscriminator(nn.Module):
    """x [B, T, 1] -> (score [B, N], feature maps [B, C, T']); every width
    capped at ``channels_cap`` and the groups at the capped width."""

    def __init__(self, use_spectral_norm: bool = False, channels_cap: int = 1024,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        conv = SNConv1d if use_spectral_norm else WNConv1d
        convs, in_ch = [], 1
        for out, k, stride, pad, groups in SCALE_SPECS:
            out = min(out, channels_cap)
            convs.append(conv(in_ch, out, k, stride=stride, padding=pad,
                              groups=min(groups, out), **kw))
            in_ch = out
        self.convs = add_layers(self, convs, prefix="convs")
        self.conv_post = conv(in_ch, 1, 3, stride=1, padding=1, **kw)
        self.use_spectral_norm = use_spectral_norm

    def forward(self, x, update_sn: bool = False):
        sn = dict(update_sn=update_sn) if self.use_spectral_norm else {}
        x = x.transpose(1, 2)
        feats = []
        for conv in self.convs:
            x = leaky_relu(conv(x, **sn))
            feats.append(x)
        x = self.conv_post(x, **sn)
        feats.append(x)
        return x.flatten(1), feats


class HifiGanDiscriminator(nn.Module):
    """The MPD (``periods``) and the MSD (``n_scales``, average-pooled
    between scales, spectral norm on the first): x [B, T, 1] -> (scores,
    feature maps), one entry a discriminator."""

    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11), n_scales: int = 3,
                 channels_cap: int = 1024, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.mpd = add_layers(self, [PeriodDiscriminator(p, channels_cap=channels_cap, **kw)
                                     for p in periods], prefix="mpd")
        self.msd = add_layers(self, [ScaleDiscriminator(i == 0, channels_cap, **kw)
                                     for i in range(n_scales)], prefix="msd")

    def forward(self, x, update_sn: bool = False):
        scores, feats = [], []
        for d in self.mpd:
            s, f = d(x)
            scores.append(s)
            feats.append(f)
        h = x
        for i, d in enumerate(self.msd):
            if i:
                h = avg_pool_1d(h, 4, 2, 2)
            s, f = d(h, update_sn=update_sn)
            scores.append(s)
            feats.append(f)
        return scores, feats


# ---- the LS-GAN losses -----------------------------------------------------------


def feature_loss(feats_real, feats_fake) -> torch.Tensor:
    loss = 0.0
    for fr, ff in zip(feats_real, feats_fake):
        for r, f in zip(fr, ff):
            loss = loss + (r - f).abs().mean()
    return loss * 2.0


def discriminator_loss(scores_real, scores_fake) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(scores_real, scores_fake):
        loss = loss + ((1.0 - r) ** 2).mean() + (f ** 2).mean()
    return loss


def generator_adv_loss(scores_fake) -> torch.Tensor:
    loss = 0.0
    for f in scores_fake:
        loss = loss + ((1.0 - f) ** 2).mean()
    return loss


# ---- the torch checkpoint import ------------------------------------------------


def _wn(state, src: str, dst: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{dst}.v"] = state[f"{src}.weight_v"]
    out[f"{dst}.g"] = state[f"{src}.weight_g"].reshape(-1)
    out[f"{dst}.bias"] = state[f"{src}.bias"]


def import_torch_generator(state: Dict[str, torch.Tensor],
                           cfg: Optional[HifiGanConfig] = None) -> Dict[str, torch.Tensor]:
    """A reference generator's state dict (``conv_pre``, ``ups.{i}``,
    ``resblocks.{r}.convs{1,2}.{j}``, ``conv_post``, each ``weight_v`` /
    ``weight_g`` / ``bias``; ``lut.weight`` with units) as this port's
    ``HifiGanGenerator`` state_dict."""
    cfg = cfg or HifiGanConfig()
    out: Dict[str, torch.Tensor] = {}
    if cfg.unit_nums is not None and "lut.weight" in state:
        out["lut"] = state["lut.weight"]
    _wn(state, "conv_pre", "conv_pre", out)
    n_up, n_k = len(cfg.upsample_factors), len(cfg.resblock_kernel_sizes)
    for i in range(n_up):
        _wn(state, f"ups.{i}", f"ups_{i}", out)
    for r in range(n_up * n_k):
        for j in range(len(cfg.resblock_dilations[r % n_k])):
            for which in ("convs1", "convs2"):
                _wn(state, f"resblocks.{r}.{which}.{j}", f"resblocks_{r}.{which}_{j}", out)
    _wn(state, "conv_post", "conv_post", out)
    return out


def import_torch_discriminator(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference ``HifiganDiscriminator``'s state dict (``mpd.discriminators.{i}``,
    five periods; ``msd.discriminators.{i}``, three scales, the first
    spectral-normalized: ``weight_orig``, ``weight_u``, ``weight_v`` over
    (I, K)) as this port's ``HifiGanDiscriminator`` state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(5):
        for c in range(5):
            _wn(state, f"mpd.discriminators.{i}.convs.{c}", f"mpd_{i}.convs_{c}", out)
        _wn(state, f"mpd.discriminators.{i}.conv_post", f"mpd_{i}.conv_post", out)
    for i in range(3):
        names = [(f"convs.{c}", f"convs_{c}") for c in range(7)] + [("conv_post", "conv_post")]
        for src, dst in names:
            src, dst = f"msd.discriminators.{i}.{src}", f"msd_{i}.{dst}"
            if i:
                _wn(state, src, dst, out)
                continue
            out[f"{dst}.v"] = state[f"{src}.weight_orig"]
            out[f"{dst}.bias"] = state[f"{src}.bias"]
            out[f"{dst}.sn_u"] = state[f"{src}.weight_u"]
            out[f"{dst}.sn_v"] = state[f"{src}.weight_v"]
    return out

