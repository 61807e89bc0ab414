"""Small sub-modules of the AVSR encoder: projector, cross-attention fusion
and speech-rate predictor.

Port of ``multimodalvc_tpu/nn/modules.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MultiHeadAttention, TransformerEncoder


class Projector(nn.Module):
    """Two linear layers, no nonlinearity."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers_0 = nn.Linear(in_dim, hidden_dim, **kw)
        self.layers_1 = nn.Linear(hidden_dim, output_dim, **kw)

    def forward(self, x):
        return self.layers_1(self.layers_0(x))


class MultimodalAttention(nn.Module):
    """The "cross-att" fusion: video queries attend to the audio twice, the
    first attention with the audio added and LayerNorm'd (eps 1e-5), the
    second added after.  ``kv_lens`` masks the audio frames."""

    def __init__(self, d_model: int, num_heads: int = 8, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.mha0 = MultiHeadAttention(d_model, num_heads, **kw)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5, **kw)
        self.mha1 = MultiHeadAttention(d_model, num_heads, **kw)

    def forward(self, audio, video, *, kv_lens=None):
        x = self.layer_norm(self.mha0(video, audio, kv_lens=kv_lens) + audio)
        return x + self.mha1(video, audio, kv_lens=kv_lens)


class SpeechRatePredictor(nn.Module):
    """Whisper features (subsampled 4x) -> scalar speech-rate factor: Linear
    in->256, a learnable SR token prepended, a 2-layer wav2vec2 encoder
    (pre-LN, ffn 1024, 4 heads, conv_pos 128/16), Linear 256->1 + ReLU."""

    def __init__(self, in_dim: int = 1024, num_layers: int = 2, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.linear = nn.Linear(in_dim, 256, **kw)
        self.sr_token = nn.Parameter(torch.zeros(1, 1, 256, **kw))
        self.encoder = TransformerEncoder(256, num_layers, 4, 1024, **kw)
        self.sr_predictor = nn.Linear(256, 1, **kw)

    def forward(self, x):
        b = x.shape[0]
        x = self.linear(x)
        x = torch.cat([self.sr_token.expand(b, 1, 256).to(x.dtype), x], dim=1)
        x = self.encoder(x)
        return F.relu(self.sr_predictor(x[:, 0, :]))
