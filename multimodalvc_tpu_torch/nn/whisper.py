"""Whisper audio encoder (the frozen acoustic front end).

Port of ``multimodalvc_tpu/nn/whisper.py``: two GELU convs over the 80-bin
log-mel (the second with stride 2), fixed sinusoidal positions, a pre-LN
transformer stack and a final LayerNorm.  whisper-medium: 24 layers,
d=1024, 16 heads, 1500 output frames at 50 Hz, padded once to 1536 so the
flash kernel sees whole tiles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .state_maps import as_tensor
from ..ops.attention import dot_product_attention, flash_attention
from ..parallel.tensor import heads_within, split_head_attention
from .layers import FeedForward, add_layers, gelu_exact, sinusoidal_positions, use_flash


@dataclass
class WhisperEncoderConfig:
    n_mels: int = 80
    d_model: int = 1024  # whisper-medium
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_frames: int = 1500

    @classmethod
    def medium(cls):
        return cls()

    @classmethod
    def tiny(cls):  # whisper-tiny, for tests
        return cls(d_model=384, num_layers=4, num_heads=6, ffn_dim=1536)


class WhisperAttention(nn.Module):
    """MHA with bias on q/v/out but not k (HF Whisper convention).  On a
    tensor axis the projections take ``MultiHeadAttention``'s forms: each
    rank attends with its H / tensor heads."""

    TENSOR_FORMS = {"q_proj": "column", "k_proj": "column", "v_proj": "column",
                    "out_proj": "row"}

    def __init__(self, d: int, num_heads: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, bias=False, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)

    def forward(self, x, *, kv_lens=None):
        b, t, d = x.shape
        hd = d // self.num_heads

        def split(z):  # this rank's heads
            return z.reshape(b, t, -1, hd).transpose(1, 2).contiguous()

        def key_mask():
            if kv_lens is None:
                return None
            return torch.arange(t, device=x.device)[None, None, None, :] < kv_lens[:, None, None, None]

        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        within = heads_within(self.num_heads, self.q_proj)
        if within is not None:
            return self.out_proj(split_head_attention(q, k, v, self.num_heads, within, key_mask()))
        q, k, v = split(q), split(k), split(v)
        if use_flash(t, t, hd, q):
            out = flash_attention(q, k, v, kv_lens=kv_lens)
        else:
            out = dot_product_attention(q, k, v, mask=key_mask())
        return self.out_proj(out.transpose(1, 2).reshape(b, t, -1))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperEncoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        self.self_attn = WhisperAttention(cfg.d_model, cfg.num_heads, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        self.ffn = FeedForward(cfg.d_model, cfg.ffn_dim, **kw)

    def forward(self, x, *, lengths=None):
        x = x + self.self_attn(self.self_attn_layer_norm(x), kv_lens=lengths)
        return x + self.ffn(self.final_layer_norm(x))


class WhisperEncoder(nn.Module):
    """[B, n_mels, 2*max_frames] log-mel -> [B, max_frames, d_model] at 50 Hz."""

    def __init__(self, cfg: WhisperEncoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.d_model, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1, **kw)
        self.layers = add_layers(self, [WhisperEncoderLayer(cfg, **kw) for _ in range(cfg.num_layers)])
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        pos = torch.from_numpy(sinusoidal_positions(cfg.max_frames, cfg.d_model))
        self.register_buffer("positions", pos.to(device=device), persistent=False)

    def forward(self, mel: torch.Tensor):
        x = gelu_exact(self.conv1(mel.to(self.conv1.weight.dtype)))
        x = gelu_exact(self.conv2(x)).transpose(1, 2)  # [B, T, d]
        t = x.shape[1]
        x = x + self.positions[None, :t].to(x.dtype)
        # pad ONCE to the flash tile multiple (1500 -> 1536); padded rows are
        # masked out of attention via lengths and sliced off at the end
        t_pad = -(-t // 512) * 512 if t >= 512 else t
        lengths = None
        if t_pad != t:
            x = F.pad(x, (0, 0, 0, t_pad - t))
            lengths = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        for layer in self.layers:
            x = layer(x, lengths=lengths)
        return self.layer_norm(x)[:, :t]


# ---- the HF weight import ---------------------------------------------------------


def import_hf_whisper_encoder(state: Mapping, cfg: WhisperEncoderConfig) -> Dict[str, torch.Tensor]:
    """An HF ``WhisperEncoder`` state dict (keys with or without the
    ``model.encoder.`` or ``encoder.`` prefix) as this module's state dict.
    The torch layouts match: the convs [O, I, K] and the linears [out, in]
    cross as they are; ``k_proj`` has no bias."""
    def get(k):
        for p in ("", "model.encoder.", "encoder."):
            if p + k in state:
                return as_tensor(state[p + k])
        raise KeyError(k)

    out: Dict[str, torch.Tensor] = {}

    def put(src, dst, bias=True):
        out[f"{dst}.weight"] = get(f"{src}.weight")
        if bias:
            out[f"{dst}.bias"] = get(f"{src}.bias")

    put("conv1", "conv1")
    put("conv2", "conv2")
    put("layer_norm", "layer_norm")
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}", f"layers_{i}"
        put(f"{src}.self_attn_layer_norm", f"{dst}.self_attn_layer_norm")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{src}.self_attn.{proj}", f"{dst}.self_attn.{proj}", bias=proj != "k_proj")
        put(f"{src}.final_layer_norm", f"{dst}.final_layer_norm")
        put(f"{src}.fc1", f"{dst}.ffn.fc1")
        put(f"{src}.fc2", f"{dst}.ffn.fc2")
    return out
