"""Conformer encoder of the speech-synthesis head.

Port of ``multimodalvc_tpu/nn/conformer.py`` (the ESPnet-lineage
Conformer): macaron FFN (x0.5), MHA with absolute interleaved sin/cos
positions (the input scaled by sqrt(d)), a conv module with k = 31
(depthwise, or the lightweight or dynamic variants of
``ops/dynamic_conv.py``) and BatchNorm + swish, LayerNorm eps 1e-12.

The mode follows the ``train`` argument, never ``module.train()``.  In
evaluation the BatchNorm runs on its running statistics and nothing drops.
In training (``train=True``) it takes flax's batch statistics: the mean and
the biased variance (E[x^2] - E[x]^2, floored at 0) over every frame of the
static buffer, padded frames included (the JAX BatchNorm sees no mask), used
to normalise and to update the running statistics as ``ra = 0.9 ra + 0.1
batch``; and ``dropout_rate`` drops, with masks drawn from ``dropout_rng``,
at the JAX sites: after the positional encoding, inside each feed-forward,
around each residual branch and on the attention output.  The BatchNorm
keeps its statistics and its affine in f32 (flax keeps its parameters in
f32) and computes in f32, whatever the module's dtype; the residual stream
runs in the module's dtype.  The self-attention is ``nn/layers.py:
MultiHeadAttention`` with the frame lengths as ``kv_lens``, so on the card
it is the K1 kernel wherever ``use_flash`` takes it (Conformer-L: 8 heads
of 64 over 2400 frames), with its gradient in training.  With
``moe_experts > 1`` each block's final FFN is the expert bank ``ff_moe``
(``parallel/expert.py: BaseMoELayer``), routed over the global token set.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dynamic_conv import dynamic_conv, lightweight_conv
from ..parallel.expert import BaseMoELayer
from ..runtime.tracing import span
from .layers import MultiHeadAttention, add_layers, batch_norm_train_, dropout

CONV_TYPES = ("depthwise", "lightweight", "dynamic")


@dataclass
class ConformerConfig:
    num_blocks: int = 12
    attention_dim: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    dropout_rate: float = 0.1
    cnn_kernel: int = 31
    macaron: bool = True
    normalize_before: bool = True
    # > 1 swaps each block's final FFN for an expert bank (parallel/expert.py)
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    conv_type: str = "depthwise"  # depthwise | lightweight | dynamic

    @classmethod
    def sized(cls, size: str, **overrides) -> "ConformerConfig":
        """The S / M / L sizes."""
        table = {
            "S": dict(num_blocks=3, attention_dim=144, attention_heads=4),
            "M": dict(num_blocks=4, attention_dim=256, attention_heads=4),
            "L": dict(num_blocks=12, attention_dim=512, attention_heads=8),
        }
        return cls(**{**table[size], **overrides})


def espnet_positional_encoding(n_pos: int, dim: int) -> np.ndarray:
    """Interleaved sin/cos table [n_pos, dim]: pe[:, 0::2] = sin, pe[:, 1::2] = cos."""
    pos = np.arange(n_pos, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(np.log(10000.0) / dim))
    pe = np.zeros((n_pos, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


@functools.lru_cache(maxsize=8)
def positional_table(t: int, dim: int, device: torch.device) -> torch.Tensor:
    """``espnet_positional_encoding`` at ``t`` positions on ``device``, built
    once a length (the JAX module builds it at trace time)."""
    return torch.from_numpy(espnet_positional_encoding(max(t, 1), dim)).to(device)


def frame_mask(lengths: Optional[torch.Tensor], t: int, device) -> Optional[torch.Tensor]:
    """[B] lengths -> [B, t, 1] bool (True = valid frame), or None."""
    if lengths is None:
        return None
    return torch.arange(t, device=device)[None, :, None] < lengths[:, None, None]


class ConformerConvModule(nn.Module):
    """pointwise -> GLU -> (frame mask) -> time conv -> BatchNorm -> swish ->
    pointwise, over [B, T, D]."""

    def __init__(self, d: int, kernel_size: int = 31, conv_type: str = "depthwise",
                 conv_heads: int = 8, device=None, dtype=None):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"conv_type {conv_type!r} not in {CONV_TYPES}")
        kw = dict(device=device, dtype=dtype)
        self.conv_type, self.conv_heads, self.kernel_size = conv_type, conv_heads, kernel_size
        self.pointwise_conv1 = nn.Linear(d, 2 * d, **kw)
        if conv_type == "lightweight":
            self.light_weights = nn.Parameter(torch.zeros(conv_heads, kernel_size, **kw))
        elif conv_type == "dynamic":
            self.weight_predictor = nn.Linear(d, conv_heads * kernel_size, **kw)
        else:
            pad = (kernel_size - 1) // 2
            self.depthwise_conv = nn.Conv1d(d, d, kernel_size, padding=pad, groups=d, **kw)
        self.norm = nn.BatchNorm1d(d, eps=1e-5, device=device, dtype=torch.float32)
        self.pointwise_conv2 = nn.Linear(d, d, **kw)

    def forward(self, x, mask: Optional[torch.Tensor] = None, train: bool = False):
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        if mask is not None:
            # padded frames hold projection-bias values; the time conv would
            # carry them (k - 1) / 2 frames into the valid region
            h = h * mask.to(h.dtype)
        pad = (self.kernel_size - 1) // 2
        if self.conv_type == "lightweight":
            h = lightweight_conv(h, self.light_weights.to(h.dtype), padding_left=pad)
        elif self.conv_type == "dynamic":
            w = self.weight_predictor(h).reshape(*h.shape[:2], self.conv_heads, self.kernel_size)
            h = dynamic_conv(h, w, padding_left=pad)
        else:
            h = self.depthwise_conv(h.transpose(1, 2)).transpose(1, 2)
        n = self.norm
        if train:
            h = batch_norm_train_(h.float(), n).to(x.dtype)
        else:
            h = F.batch_norm(h.float().transpose(1, 2), n.running_mean, n.running_var, n.weight,
                             n.bias, training=False, eps=n.eps).transpose(1, 2).to(x.dtype)
        return self.pointwise_conv2(h * torch.sigmoid(h))


class PositionwiseFF(nn.Module):
    def __init__(self, d: int, hidden: int, dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        self.dropout = dropout
        self.w_1 = nn.Linear(d, hidden, device=device, dtype=dtype)
        self.w_2 = nn.Linear(hidden, d, device=device, dtype=dtype)

    def forward(self, x, dropout_rng: Optional[torch.Generator] = None):
        return self.w_2(dropout(F.relu(self.w_1(x)), self.dropout, dropout_rng))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.attention_dim
        self.macaron, self.dropout_rate = cfg.macaron, cfg.dropout_rate
        ln = lambda: nn.LayerNorm(d, eps=1e-12, **kw)  # noqa: E731
        if cfg.macaron:
            self.norm_ff_macaron = ln()
            self.ff_macaron = PositionwiseFF(d, cfg.linear_units, cfg.dropout_rate, **kw)
        self.norm_mha = ln()
        self.self_attn = MultiHeadAttention(d, cfg.attention_heads, dropout=cfg.dropout_rate,
                                            **kw)
        self.norm_conv = ln()
        self.conv_module = ConformerConvModule(d, cfg.cnn_kernel, cfg.conv_type,
                                               cfg.attention_heads, **kw)
        self.norm_ff = ln()
        if cfg.moe_experts > 1:
            self.ff_moe = BaseMoELayer(d, cfg.moe_experts, cfg.linear_units,
                                       cfg.moe_capacity_factor, **kw)
        else:
            self.ff = PositionwiseFF(d, cfg.linear_units, cfg.dropout_rate, **kw)
        self.norm_final = ln()

    def forward(self, x, lengths: Optional[torch.Tensor] = None, train: bool = False,
                dropout_rng: Optional[torch.Generator] = None):
        def drop(h):
            return dropout(h, self.dropout_rate, dropout_rng)

        if self.macaron:
            x = x + 0.5 * drop(self.ff_macaron(self.norm_ff_macaron(x), dropout_rng))
        x = x + drop(self.self_attn(self.norm_mha(x), kv_lens=lengths, dropout_rng=dropout_rng))
        x = x + drop(self.conv_module(self.norm_conv(x), frame_mask(lengths, x.shape[1], x.device),
                                      train))
        h = self.norm_ff(x)
        x = x + 0.5 * drop(self.ff_moe(h) if hasattr(self, "ff_moe") else self.ff(h, dropout_rng))
        return self.norm_final(x)


class ConformerEncoder(nn.Module):
    """[B, T, in_dim] -> [B, T, attention_dim]; ``input_proj`` only where the
    widths differ.  ``lengths`` [B] masks the attention's keys and the conv
    module's input past each row's frames.  ``train`` selects the BatchNorm's
    batch statistics; ``dropout_rng`` (training) draws the dropout."""

    def __init__(self, cfg: ConformerConfig, in_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.dropout_rate = cfg, cfg.dropout_rate
        d = cfg.attention_dim
        if in_dim != d:
            self.input_proj = nn.Linear(in_dim, d, **kw)
        self.blocks = add_layers(self, [ConformerBlock(cfg, **kw) for _ in range(cfg.num_blocks)],
                                 prefix="blocks")
        if cfg.normalize_before:
            self.after_norm = nn.LayerNorm(d, eps=1e-12, **kw)

    def forward(self, x, lengths: Optional[torch.Tensor] = None, train: bool = False,
                dropout_rng: Optional[torch.Generator] = None):
        if hasattr(self, "input_proj"):
            x = self.input_proj(x)
        t, d = x.shape[1], self.cfg.attention_dim
        with span("conformer.scale.wait"):  # a host number copied to the device
            scale = x.new_tensor(np.sqrt(d))
        x = (x * scale + positional_table(t, d, x.device)).to(x.dtype)
        x = dropout(x, self.dropout_rate, dropout_rng)
        for block in self.blocks:
            x = block(x, lengths, train, dropout_rng)
        if self.cfg.normalize_before:
            x = self.after_norm(x)
        return x
