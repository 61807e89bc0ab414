"""Legacy encoder-decoder ASR head: a transformer decoder over AV-HuBERT.

Port of ``multimodalvc_tpu/nn/seq2seq.py``: ``Seq2SeqDecoder`` (token
embedding scaled by sqrt(d), sinusoidal positions, pre-LN layers of causal
self-attention with a KV cache written at the cache's ``index``,
cross-attention under an encoder length mask, an erf-GELU FFN, a final
LayerNorm and the output tied to the embedding, in f32) and
``generate_seq2seq``, fairseq's SequenceGenerator over the port's
``ops/beam_search.py``: ``beam_search`` (K4 on the card) or, with
constraints, ``constrained_beam_search``.  The cache leaves are [B, L, H,
Dh]; at the default config Dh = 192, which K6's gate does not take, so the
beam reorder gathers them in PyTorch.  The JAX package wires no encoder
into it, and neither does the port.  Inference only: the FFN dropout of a
JAX training forward is not ported (no JAX caller runs one).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import FeedForward, gelu_exact, sinusoidal_positions


@dataclass
class Seq2SeqDecoderConfig:
    vocab_size: int = 1000
    d_model: int = 768
    num_layers: int = 6
    num_heads: int = 4
    ffn_dim: int = 3072
    dropout: float = 0.1
    max_positions: int = 1024
    eos_token_id: int = 2
    pad_token_id: int = 1

    @classmethod
    def tiny(cls, vocab_size: int = 64):
        return cls(vocab_size=vocab_size, d_model=32, num_layers=2, num_heads=2, ffn_dim=64)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Seq2SeqDecoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.heads, self.head_dim = cfg.num_heads, d // cfg.num_heads
        for name in ("self_q", "self_k", "self_v", "self_out", "cross_q", "cross_k", "cross_v",
                     "cross_out"):
            self.add_module(name, nn.Linear(d, d, **kw))
        for name in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            self.add_module(name, nn.LayerNorm(d, eps=1e-5, **kw))
        self.FeedForward_0 = FeedForward(d, cfg.ffn_dim, activation=gelu_exact, **kw)

    def _heads(self, y):  # [B, T, D] -> [B, H, T, Dh]
        return y.reshape(y.shape[0], y.shape[1], self.heads, self.head_dim).transpose(1, 2)

    def forward(self, x, enc, cross_mask, self_mask, cache: Optional[Dict] = None):
        res = x
        h = self.self_attn_layer_norm(x)
        q, k, v = (self._heads(proj(h)) for proj in (self.self_q, self.self_k, self.self_v))
        new_cache = None
        if cache is not None:
            # write this block at the cache's index; attend over the whole cache
            idx, t = cache["index"], x.shape[1]
            cache["k"][:, idx: idx + t] = k.transpose(1, 2)
            cache["v"][:, idx: idx + t] = v.transpose(1, 2)
            new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + t}
            k, v = cache["k"].transpose(1, 2), cache["v"].transpose(1, 2)
        attn = dot_product_attention(q, k, v, mask=self_mask)
        x = res + self.self_out(attn.transpose(1, 2).reshape(res.shape))

        res = x
        h = self.encoder_attn_layer_norm(x)
        q = self._heads(self.cross_q(h))
        ek, ev = self._heads(self.cross_k(enc)), self._heads(self.cross_v(enc))
        attn = dot_product_attention(q, ek, ev, mask=cross_mask)
        x = res + self.cross_out(attn.transpose(1, 2).reshape(res.shape))

        return x + self.FeedForward_0(self.final_layer_norm(x)), new_cache


class Seq2SeqDecoder(nn.Module):
    """Transformer decoder with sinusoidal positions and a tied output."""

    def __init__(self, cfg: Seq2SeqDecoderConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", DecoderLayer(cfg, **kw))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5, **kw)
        self.register_buffer("positions", torch.from_numpy(
            sinusoidal_positions(cfg.max_positions, cfg.d_model)).to(device), persistent=False)

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def init_cache(self, batch: int, max_len: int) -> Tuple[Dict, ...]:
        """One {"k", "v": [B, max_len, H, Dh] zeros, "index": 0} a layer."""
        h, dh = self.cfg.num_heads, self.cfg.d_model // self.cfg.num_heads
        w = self.embed_tokens.weight
        return tuple({"k": w.new_zeros(batch, max_len, h, dh), "v": w.new_zeros(batch, max_len, h, dh),
                      "index": 0} for _ in range(self.cfg.num_layers))

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor, enc_lens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, cache: Optional[Tuple] = None):
        """tokens [B, T], enc [B, S, D] (already d_model wide), enc_lens [B]
        -> {"logits": [B, T, V] f32, "cache": the caches with this block
        written (None without a cache)}.  With a cache the block attends to
        every slot up to its own; without, causally."""
        b, t = tokens.shape
        if positions is None:
            positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
        x = self.embed_tokens(tokens) * math.sqrt(self.cfg.d_model)
        x = (x + self.positions.to(x.dtype)[positions.long()]).to(self.embed_tokens.weight.dtype)
        if cache is not None:
            slots = cache[0]["k"].shape[1]
            self_mask = (torch.arange(slots, device=x.device) <= cache[0]["index"] + t - 1)
            self_mask = self_mask[None, None, None, :].expand(b, 1, t, slots)
        else:
            self_mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()[None, None]
        cross_mask = (torch.arange(enc.shape[1], device=x.device)[None, None, None, :]
                      < enc_lens[:, None, None, None])
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, c = layer(x, enc, cross_mask, self_mask, None if cache is None else cache[i])
            new_caches.append(c)
        x = self.layer_norm(x)
        logits = torch.einsum("btd,vd->btv", x.float(), self.embed_tokens.weight.float())
        return {"logits": logits, "cache": tuple(new_caches) if cache is not None else None}


@torch.no_grad()
def generate_seq2seq(decoder: Seq2SeqDecoder, enc: torch.Tensor, enc_lens: torch.Tensor,
                     bos_token_id: int, max_new_tokens: int = 100, num_beams: int = 5,
                     length_penalty: float = 1.0, constraints=None,
                     constraints_mode: str = "unordered"):
    """Beam-decode from the encoder states ``enc`` [B, S, d_model]: BOS
    through the decoder, then ``beam_search`` (or, with ``constraints``, a
    packed [B, maxlen] array of ``ops/constraints.py: pack_constraints``,
    ``constrained_beam_search``).  Returns (sequences [B, K, L], scores [B,
    K])."""
    from ..ops import constraints as C
    from ..ops.beam_search import beam_search, constrained_beam_search

    cfg = decoder.cfg
    b, k = enc.shape[0], num_beams
    cache = decoder.init_cache(b, 1 + max_new_tokens)
    bos = torch.full((b, 1), bos_token_id, dtype=torch.long, device=enc.device)
    out = decoder(bos, enc, enc_lens, cache=cache)
    first_logits = out["logits"][:, -1]
    enc_k = enc.repeat_interleave(k, dim=0)
    lens_k = enc_lens.repeat_interleave(k, dim=0)
    cache_k = tuple({key: v.repeat_interleave(k, dim=0) if torch.is_tensor(v) else v
                     for key, v in c.items()} for c in out["cache"])

    def decode_fn(tokens, positions, cache):
        o = decoder(tokens, enc_k, lens_k, positions=positions, cache=cache)
        return o["logits"][:, -1], o["cache"]

    common = dict(prompt_lengths=torch.ones(b, dtype=torch.long, device=enc.device),
                  first_logits=first_logits, eos_token_id=cfg.eos_token_id,
                  pad_token_id=cfg.pad_token_id, max_new_tokens=max_new_tokens, num_beams=k,
                  length_penalty=length_penalty)
    if constraints is not None:
        build = C.build_unordered if constraints_mode == "unordered" else C.build_ordered
        return constrained_beam_search(decode_fn, cache_k,
                                       constraint_set=build(np.asarray(constraints)),
                                       mode=constraints_mode, **common)
    return beam_search(decode_fn, cache_k, **common)
