"""Q-Former: query-token compressor with per-layer cross-attention.

Port of ``multimodalvc_tpu/nn/qformer.py`` (query path only; post-LN BERT
layers with eps 1e-12; query slots fixed at max_queries and masked per
sample; in training, dropout ``cfg.dropout`` on the embedded query tokens,
each attention output and each FFN output, drawn from ``dropout_rng``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .layers import MultiHeadAttention, add_layers, dropout, gelu_exact


@dataclass
class QFormerConfig:
    num_layers: int = 2
    hidden_size: int = 1024
    num_heads: int = 16
    intermediate_size: int = 4096
    encoder_width: int = 2048  # fused AV feature dim (concat: 1024+1024)
    max_queries: int = 80
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12


class QFormerLayer(nn.Module):
    # the JAX rules split both FFN kernels by columns (their names end in
    # "query"): each gathers its output
    TENSOR_FORMS = {"intermediate_query": "column_gather", "output_query": "column_gather"}

    def __init__(self, cfg: QFormerConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.dropout = cfg.dropout
        ln = lambda: nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)  # noqa: E731
        self.self_attn = MultiHeadAttention(d, cfg.num_heads, dropout=cfg.dropout, **kw)
        self.self_ln = ln()
        self.cross_attn = MultiHeadAttention(d, cfg.num_heads, kv_dim=cfg.encoder_width,
                                             dropout=cfg.dropout, **kw)
        self.cross_ln = ln()
        self.intermediate_query = nn.Linear(d, cfg.intermediate_size, **kw)
        self.output_query = nn.Linear(cfg.intermediate_size, d, **kw)
        self.ffn_ln = ln()

    def forward(self, x, enc, *, query_lens=None, enc_lens=None, dropout_rng=None):
        x = self.self_ln(x + self.self_attn(x, kv_lens=query_lens, dropout_rng=dropout_rng))
        x = self.cross_ln(x + self.cross_attn(x, enc, kv_lens=enc_lens, dropout_rng=dropout_rng))
        h = self.output_query(gelu_exact(self.intermediate_query(x)))
        return self.ffn_ln(x + dropout(h, self.dropout, dropout_rng))


class QFormer(nn.Module):
    """Learned query tokens cross-attending to fused AV features; returns
    [B, max_queries, hidden] with slots past query_lens[b] zeroed."""

    def __init__(self, cfg: QFormerConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.dropout = cfg.dropout
        self.query_tokens = nn.Parameter(torch.zeros(1, cfg.max_queries, cfg.hidden_size, **kw))
        self.embeddings_ln = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)
        self.layers = add_layers(self, [QFormerLayer(cfg, **kw) for _ in range(cfg.num_layers)])

    def forward(self, enc, *, query_lens: Optional[torch.Tensor] = None,
                enc_lens: Optional[torch.Tensor] = None,
                dropout_rng: Optional[torch.Generator] = None):
        cfg = self.cfg
        b = enc.shape[0]
        x = self.embeddings_ln(self.query_tokens.expand(b, -1, -1))
        x = dropout(x, self.dropout, dropout_rng)
        for layer in self.layers:
            x = layer(x, enc, query_lens=query_lens, enc_lens=enc_lens, dropout_rng=dropout_rng)
        if query_lens is not None:
            valid = torch.arange(cfg.max_queries, device=x.device)[None, :, None] < query_lens[:, None, None]
            x = torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))
        return x
