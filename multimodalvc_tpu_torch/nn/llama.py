"""LLaMA decoder with LoRA adapters, a KV cache and beam generation.

Port of ``multimodalvc_tpu/nn/llama.py``: RMSNorm pre-norm, GQA attention
with llama3-scaled RoPE, SwiGLU MLP, tied embeddings.  Weights are float, or
weight-only int8 / int4 (``LlamaConfig.weight_quant``: every projection and
the tied unembed become ``QuantDense``, K7 ``int8_matmul`` or K8
``int4_matmul``).  The cache is a tuple of per-layer dicts with the JAX keys.
Unlike the JAX package, its tensors are updated in place (the cache
``index`` is a Python int): a decode step writes one slot instead of
copying the cache.

``generate_beam`` serves the split cache, with the prompt KV shared across
beams, in three forms, and a full per-beam cache (``share_prompt_kv=False``):

- the ancestry map with an int8 KV cache: ``ancestry_attention`` in every
  layer, K2's prompt segment, K3's generated segment and their merge in one
  kernel launch;
- the ancestry map with a bf16 (or f32) KV cache: the prompt segment as
  plain einsums, as the JAX package leaves it to XLA, and the generated
  segment through K3;
- the gather reorder with a bf16 (or f32) KV cache: one softmax over the
  prompt and the generated scores as grouped einsums, and the per-beam
  generated segment reordered physically every step (K6 ``gather_rows``).

It also serves ensembles and constrained decoding.  K4 (or K5 with n-gram
blocking) picks the beam candidates in every step.  Prefill attention at serving
prompt lengths stays plain tensor code, as the JAX package leaves it to XLA
(``_flash_prefill_ok``).

Training: ``LlamaModel.forward(..., dropout_rng=, return_hidden=)`` is the
training forward (LoRA dropout drawn from an explicit generator), and
``cross_entropy_lm_loss`` its loss.  The flash path carries a gradient
(``ops/attention.py: FlashAttentionGrad``), and so does the tied unembed's
bf16 product with f32 logits (``TiedUnembed``).  ``pipeline_lm_forward`` is
the training forward with the decoder layers split over the mesh's
pipeline axis (``parallel/pipeline.py``).

On a tensor axis (``parallel/tensor.py``) the JAX rules split the MLP's
``gate_proj`` / ``up_proj`` by columns (their product is gathered before
the whole ``down_proj``) and ``embed_tokens`` by vocabulary rows: the
lookup masks the other ranks' ids and all-reduces, the tied unembed gives
the logits over the rank's vocabulary, and ``cross_entropy_lm_loss`` (given
the table as ``vocab``) the whole vocabulary's loss and argmax.  The
attention projections stay whole (their kernels sit under ``base``, which
the JAX rules do not match).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .state_maps import as_tensor
from ..ops.attention import flash_attention
from ..ops.beam_search import beam_search, constrained_beam_search, log_softmax
from ..ops.decode_attention import (
    ancestry_attention,
    gen_attention_ancestor,
    merge_softmax_segments,
    quantize_kv,
)
from ..ops.int8_matmul import (
    INT4_GROUP,
    int4_matmul,
    int8_matmul,
    quantize_kernel,
    quantize_kernel_int4,
)
from ..parallel.collectives import copy_to_tensor_region, reduce_from_tensor_region
from ..parallel.mesh import batch_group_rank, batch_total
from ..parallel.tensor import VocabParallelEmbedding, gather_columns, vocab_parallel
from ..parallel.pipeline import microbatch, pipeline_apply, unmicrobatch
from .layers import add_layers, dropout, remat

NEG = -1e30


@dataclass
class LoraConfig:
    rank: int = 16
    alpha: int = 32
    dropout: float = 0.05  # on the adapter's input, in training
    targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")


@dataclass
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    lora: Optional[LoraConfig] = field(default_factory=LoraConfig)
    # rematerialise each decoder layer's activations in the backward
    # (``layers.remat``; the pipelined loss runs its layers without)
    remat: bool = False
    # flash prefill gate: None = auto (padded t >= 512 and batch*t >= 4096)
    use_flash_prefill: Optional[bool] = None
    # weight-only quantized serving: None (float), "int8" or "int4"
    weight_quant: Optional[str] = None

    @classmethod
    def llama32_3b(cls):
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256):  # for tests
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
        )


def llama3_rope_frequencies(cfg: LlamaConfig) -> np.ndarray:
    """Per-dimension inverse frequencies with llama3 NTK-by-parts scaling."""
    dim = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    if cfg.rope_scaling_factor and cfg.rope_scaling_factor != 1.0:
        low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2 * np.pi / inv_freq
        scaled = inv_freq / cfg.rope_scaling_factor
        smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
        )
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = np.where(wavelen > low_wavelen, scaled, inv_freq)
        mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
        inv_freq = np.where(mid, smoothed, inv_freq)
    return inv_freq.astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [B, H, T, D], positions: [B, T] -> rotated x (HF half-split layout)."""
    angles = positions[:, :, None].float() * inv_freq[None, None, :]  # [B, T, D/2]
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        x32 = x.float()
        normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + self.eps)
        return (normed * self.weight.float()).to(self.weight.dtype)


def quantize_weight(weight: torch.Tensor, mode: str) -> Dict[str, torch.Tensor]:
    """A float ``weight`` [out, in] (torch layout) -> the ``QuantDense``
    buffers, in the flax [in, out] layout of the JAX package."""
    if mode == "int4":
        w_packed, w_scale = quantize_kernel_int4(weight.T)
        return {"w_packed": w_packed, "w_scale": w_scale}
    if mode == "int8":
        w_q, w_scale = quantize_kernel(weight.T)
        return {"w_q": w_q, "w_scale": w_scale}
    raise ValueError(f"unsupported weight_quant {mode!r}")


class QuantDense(nn.Module):
    """Dense with weight-only quantized weights (the flax ``QuantDense``).

    mode "int8": ``w_q`` [d_in, d_out] int8 and ``w_scale`` [d_out] f32 (K7);
    mode "int4": ``w_packed`` [d_in/2, d_out] int8, two half-split nibbles a
    byte, and ``w_scale`` [d_in/128, d_out] f32 (K8).  The leaves keep the
    flax [d_in, d_out] layout and are buffers (serving weights, not trained).
    The output type is ``dtype``."""

    def __init__(self, d_in: int, features: int, mode: str = "int8", device=None, dtype=None):
        super().__init__()
        self.mode = mode
        self.dtype = dtype or torch.get_default_dtype()
        kw = dict(device=device)
        if mode == "int4":
            self.register_buffer("w_packed", torch.zeros(d_in // 2, features, dtype=torch.int8, **kw))
            self.register_buffer("w_scale", torch.ones(d_in // INT4_GROUP, features, **kw))
        elif mode == "int8":
            self.register_buffer("w_q", torch.zeros(d_in, features, dtype=torch.int8, **kw))
            self.register_buffer("w_scale", torch.ones(features, **kw))
        else:
            raise ValueError(f"unsupported weight_quant {mode!r}")

    @classmethod
    def from_weight(cls, weight: torch.Tensor, mode: str, dtype) -> "QuantDense":
        """The quantized copy of a float ``weight`` [out, in], on its device."""
        out_f, in_f = weight.shape
        mod = cls(in_f, out_f, mode, device="meta", dtype=dtype)
        for name, buf in quantize_weight(weight, mode).items():
            setattr(mod, name, buf)
        return mod

    def forward(self, x):
        if self.mode == "int4":
            return int4_matmul(x, self.w_packed, self.w_scale, out_dtype=self.dtype)
        return int8_matmul(x, self.w_q, self.w_scale, out_dtype=self.dtype)


class LoraDense(nn.Module):
    """Dense with an additive low-rank adapter: y = xW + s*(x A) B.  The
    adapter factors keep the flax layout: lora_a [in, r], lora_b [r, out].
    With ``quant`` the base is a ``QuantDense`` named ``base_q``; the adapter
    stays float and is added after the base product.  In training (a
    ``dropout_rng``) the adapter's input takes the LoRA dropout."""

    def __init__(self, d_in: int, features: int, lora: Optional[LoraConfig],
                 quant: Optional[str] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.quant = quant
        if quant:
            self.base_q = QuantDense(d_in, features, quant, **kw)
        else:
            self.base = nn.Linear(d_in, features, bias=False, **kw)
        self.scale = 0.0
        self.dropout = lora.dropout if lora is not None else 0.0
        if lora is not None and lora.rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(d_in, lora.rank, **kw))
            self.lora_b = nn.Parameter(torch.zeros(lora.rank, features, **kw))
            self.scale = lora.alpha / lora.rank

    def quantize_(self, mode: str) -> None:
        """Replace the float base by its quantized copy, in place."""
        self.base_q = QuantDense.from_weight(self.base.weight, mode, self.base.weight.dtype)
        del self.base
        self.quant = mode

    def forward(self, x, dropout_rng: Optional[torch.Generator] = None):
        y = self.base_q(x) if self.quant else self.base(x)
        if self.scale:
            h = dropout(x, self.dropout, dropout_rng)
            y = y + (h @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * self.scale
        return y


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.dtype = dtype or torch.get_default_dtype()
        h, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        lora = lambda name: cfg.lora if (cfg.lora and name in cfg.lora.targets) else None  # noqa: E731
        wq = cfg.weight_quant
        self.q_proj = LoraDense(d, h * hd, lora("q_proj"), wq, **kw)
        self.k_proj = LoraDense(d, hkv * hd, lora("k_proj"), wq, **kw)
        self.v_proj = LoraDense(d, hkv * hd, lora("v_proj"), wq, **kw)
        self.o_proj = LoraDense(h * hd, d, lora("o_proj"), wq, **kw)
        inv = torch.from_numpy(llama3_rope_frequencies(cfg))
        self.register_buffer("inv_freq", inv.to(device=device), persistent=False)

    def _flash_prefill_ok(self, t: int, tkv: int, head_dim: int, batch: int = 0) -> bool:
        """Static gate for the flash self-attention path (the JAX gate, kept
        as measured on the v5e: short serving prompts stay plain)."""
        enabled = self.cfg.use_flash_prefill
        if enabled is None:
            t_padded = -(-t // 128) * 128
            enabled = t_padded >= 512 and batch * t >= 4096
        return bool(enabled) and t == tkv and t > 1 and head_dim % 64 == 0

    def _flash_self(self, q, k, v, attn_mask, rep: int):
        """Causal flash self-attention with the left-pad mask folded into a
        per-row [start, T) key window."""
        t = q.shape[2]
        kf = k.repeat_interleave(rep, dim=1) if rep > 1 else k
        vf = v.repeat_interleave(rep, dim=1) if rep > 1 else v
        starts = None
        if attn_mask is not None:
            starts = (t - attn_mask[:, :t].to(torch.int32).sum(dim=-1)).to(torch.int32)
        return flash_attention(
            q.to(self.dtype).contiguous(), kf.to(self.dtype).contiguous(),
            vf.to(self.dtype).contiguous(), kv_starts=starts, causal=True,
            scale=1.0 / math.sqrt(q.shape[-1]),
        )

    def _ancestry_step(self, q, k, v, cache) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode token against the split cache with the ancestry map.
        An int8 cache takes ``ancestry_attention`` (both segments and their
        merge in one launch); a bf16/f32 cache the prompt segment as plain
        einsums, the generated segment through K3, and the merge."""
        cfg = self.cfg
        b = q.shape[0]
        h, hd = cfg.num_heads, cfg.head_dim
        idx = cache["index"]
        k_sl, v_sl = k.transpose(1, 2), v.transpose(1, 2)  # [B*K, 1, hkv, d]
        kv_q = cache["fixed_k"].dtype == torch.int8
        if kv_q:
            k_sl, k_sc = quantize_kv(k_sl)  # scales [B*K, 1, hkv]
            v_sl, v_sc = quantize_kv(v_sl)
            cache["fixed_ks"][:, idx : idx + 1] = k_sc
            cache["fixed_vs"][:, idx : idx + 1] = v_sc
        cache["fixed_k"][:, idx : idx + 1] = k_sl
        cache["fixed_v"][:, idx : idx + 1] = v_sl
        nb = cache["prompt_k"].shape[0]
        kbeams = b // nb
        anc = cache["anc"]
        anc[:, idx] = torch.arange(b, dtype=anc.dtype, device=anc.device) % kbeams
        new_cache = {**cache, "index": idx + 1}
        scale = 1.0 / math.sqrt(hd)
        q_flat = q[:, :, 0, :].to(self.dtype).contiguous()  # [B*K, h, d]
        if kv_q:
            out = ancestry_attention(
                q_flat, cache["prompt_k"], cache["prompt_v"], cache["prompt_mask"],
                cache["fixed_k"], cache["fixed_v"], anc, idx + 1, beams=kbeams, scale=scale,
                prompt_k_scale=cache["prompt_ks"], prompt_v_scale=cache["prompt_vs"],
                gen_k_scale=cache["fixed_ks"], gen_v_scale=cache["fixed_vs"],
                out_dtype=self.dtype,
            )
        else:
            out_p, m_p, l_p = self._prompt_partials(q, cache, kbeams, scale)
            out_g, m_g, l_g = gen_attention_ancestor(
                q_flat, cache["fixed_k"], cache["fixed_v"], anc, idx + 1, beams=kbeams,
                scale=scale,
            )
            out = merge_softmax_segments(out_p, m_p, l_p, out_g, m_g, l_g).to(self.dtype)
        return self.o_proj(out.reshape(b, 1, h * hd)), new_cache

    def _prompt_scores(self, q, cache, scale: float) -> torch.Tensor:
        """f32 scores [B*K, h, t, Tp] of the decode queries q [B*K, h, t, d]
        against the shared bf16/f32 prompt keys [B, hkv, Tp, d], as a grouped
        GQA einsum, with the invalid prompt slots at NEG."""
        b, h, t, hd = q.shape
        pk = cache["prompt_k"]
        nb, hkv, tp = pk.shape[:3]
        q_r = q.reshape(nb, b // nb, hkv, h // hkv, t, hd)
        s_p = torch.einsum("bkgrtd,bgpd->bkgrtp", q_r.float(), pk.to(self.dtype).float()) * scale
        pmask = cache["prompt_mask"].bool()[:, None, None, None, None, :]
        return torch.where(pmask, s_p, NEG).reshape(b, h, t, tp)

    def _prompt_partials(self, q, cache, kbeams: int, scale: float):
        """Softmax partials of one decode token against the shared bf16/f32
        prompt KV, in the JAX op order (nn/llama.py:350-367): f32 scores,
        probabilities cast to the compute type for the P.V product, whose
        result is then cast to f32.  A batch element with no valid slot gives
        m = -1e30 and uniform weights; the merge then ignores it."""
        cfg = self.cfg
        b = q.shape[0]
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        pv = cache["prompt_v"]  # [B, hkv, Tp, d]
        nb, tp = pv.shape[0], pv.shape[2]
        s_p = self._prompt_scores(q, cache, scale)[:, :, 0]  # t == 1 squeezed
        m_p = s_p.amax(dim=-1)
        p_p = torch.exp(s_p - m_p[..., None])
        l_p = p_p.sum(dim=-1)
        out_p = torch.einsum(
            "bkgrp,bgpd->bkgrd", p_p.reshape(nb, kbeams, hkv, h // hkv, tp).to(self.dtype),
            pv.to(self.dtype),
        )
        return out_p.reshape(b, h, hd).float(), m_p, l_p

    def _gather_step(self, q, k, v, cache) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Decode tokens against the split cache whose per-beam generated
        segment ``k``/``v`` [B*K, L, hkv, d] is reordered physically by the
        beam search: one softmax over the prompt and the generated scores, as
        grouped GQA einsums (q as [.., hkv, rep, ..] against the hkv-headed
        keys, no per-head copies of the cache), in the JAX op order
        (nn/llama.py:383-454)."""
        cfg = self.cfg
        b, _, t, _ = q.shape
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        rep = h // hkv
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        ck[:, idx : idx + t] = k.transpose(1, 2).to(ck.dtype)
        cv[:, idx : idx + t] = v.transpose(1, 2).to(cv.dtype)
        new_cache = {**cache, "index": idx + t}
        pv = cache["prompt_v"]  # [B, hkv, Tp, d]
        nb, tp = pv.shape[0], pv.shape[2]
        kbeams = b // nb
        scale = 1.0 / math.sqrt(hd)
        pv_c = pv.to(self.dtype)
        s_p = self._prompt_scores(q, cache, scale)
        q_g = q.reshape(b, hkv, rep, t, hd)
        s_g = torch.einsum("Bgrtd,Blgd->Bgrtl", q_g.float(), ck.to(self.dtype).float()) * scale
        tg = ck.shape[1]
        s_g = s_g.reshape(b, h, t, tg)
        gen_valid = torch.arange(tg, device=q.device) <= idx + t - 1
        s_g = torch.where(gen_valid, s_g, NEG)
        w = torch.softmax(torch.cat([s_p, s_g], dim=-1), dim=-1)
        w_p, w_g = w[..., :tp], w[..., tp:]
        out_p = torch.einsum(
            "bkgrtp,bgpd->bkgrtd", w_p.reshape(nb, kbeams, hkv, rep, t, tp).to(self.dtype), pv_c,
        ).reshape(b, h, t, hd)
        out_g = torch.einsum(
            "Bgrtl,Blgd->Bgrtd", w_g.reshape(b, hkv, rep, t, tg).to(self.dtype),
            cv.to(self.dtype),
        ).reshape(b, h, t, hd)
        out = (out_p + out_g).transpose(1, 2).reshape(b, t, h * hd)
        return self.o_proj(out), new_cache

    def forward(self, x, positions, attn_mask, cache=None, cache_positions=None,
                dropout_rng=None):
        cfg = self.cfg
        b, t, _ = x.shape
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x, dropout_rng).reshape(b, t, h, hd).transpose(1, 2)
        k = self.k_proj(x, dropout_rng).reshape(b, t, hkv, hd).transpose(1, 2)
        v = self.v_proj(x, dropout_rng).reshape(b, t, hkv, hd).transpose(1, 2)
        q = apply_rope(q, positions, self.inv_freq)
        k = apply_rope(k, positions, self.inv_freq)

        rep = h // hkv
        if cache is not None and "anc" in cache:
            if t != 1:
                raise ValueError("the ancestry decode is a single-token path")
            return self._ancestry_step(q, k, v, cache)
        if cache is not None and "prompt_k" in cache:
            return self._gather_step(q, k, v, cache)
        new_cache = None
        if cache is not None:
            idx = cache["index"]
            ck, cv = cache["k"], cache["v"]
            ck[:, :, idx : idx + t] = k.to(ck.dtype)
            cv[:, :, idx : idx + t] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv, "index": idx + t}
            if self._flash_prefill_ok(t, ck.shape[2], hd, batch=b):
                out = self._flash_self(q, k, v, attn_mask, rep)
                return self.o_proj(out.transpose(1, 2).reshape(b, t, h * hd)), new_cache
            k, v = ck, cv
        elif cache_positions is None and self._flash_prefill_ok(t, k.shape[2], hd, batch=b):
            # the training forward (arange positions: slot causality is row
            # causality), the left-pad mask as a per-row key window
            out = self._flash_self(q, k, v, attn_mask, rep)
            return self.o_proj(out.transpose(1, 2).reshape(b, t, h * hd), dropout_rng), new_cache
        tkv = k.shape[2]
        # causal over cache SLOT indices (left-padded rows have RoPE
        # position < slot id, so positions must not drive causality here)
        kv_ids = torch.arange(tkv, device=x.device)[None, None, None, :]
        q_slots = cache_positions if cache_positions is not None else positions
        mask = kv_ids <= q_slots[:, None, :, None]
        if attn_mask is not None:
            mask = mask & attn_mask[:, None, None, :].bool()
        # grouped GQA: q as [b, hkv, rep, t, d] against the hkv-headed keys
        qg = q.reshape(b, hkv, rep, t, hd)
        s = torch.einsum("bgrtd,bgld->bgrtl", qg.float(), k.float()) * (1.0 / math.sqrt(hd))
        s = torch.where(mask[:, :, None], s, -1e30)
        w = torch.softmax(s, dim=-1)
        out_dtype = torch.promote_types(self.dtype, v.dtype)
        out = torch.einsum("bgrtl,bgld->bgrtd", w.to(out_dtype), v.to(out_dtype))
        out = out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)
        return self.o_proj(out.to(self.dtype), dropout_rng), new_cache


class LlamaMLP(nn.Module):
    TENSOR_FORMS = {"gate_proj": "column", "up_proj": "column"}

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if cfg.weight_quant:  # QuantDense directly, no base_q level (the flax tree)
            dense = lambda i, o: QuantDense(i, o, cfg.weight_quant, **kw)  # noqa: E731
        else:
            dense = lambda i, o: nn.Linear(i, o, bias=False, **kw)  # noqa: E731
        self.gate_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = F.silu(self.gate_proj(x)) * self.up_proj(x)
        return self.down_proj(gather_columns(h, self.gate_proj))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(cfg, **kw)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(cfg, **kw)

    def forward(self, x, positions, attn_mask, cache=None, cache_positions=None,
                dropout_rng=None):
        attn_out, new_cache = self.self_attn(
            self.input_layernorm(x), positions, attn_mask, cache, cache_positions, dropout_rng
        )
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache


def _layer_state(layer, x, positions, attn_mask, dropout_rng):
    """A training layer's output state (no cache), for ``remat``."""
    return layer(x, positions, attn_mask, None, None, dropout_rng)[0]


class LlamaModel(nn.Module):
    """Decoder trunk. Accepts token ids or pre-built input embeddings."""

    TENSOR_FORMS = {"embed_tokens": "vocab"}

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.dtype = dtype or torch.get_default_dtype()
        # quantized serving keeps a bf16 table for the input gather only
        emb_dtype = torch.bfloat16 if cfg.weight_quant else dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device,
                                         dtype=emb_dtype)
        self.layers = add_layers(self, [LlamaLayer(cfg, **kw) for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        if cfg.weight_quant:
            # the tied lm_head as a quantized copy of embed^T, f32 logits
            self.unembed_q = QuantDense(cfg.hidden_size, cfg.vocab_size, cfg.weight_quant,
                                        device=device, dtype=torch.float32)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        # gather the rows first, then cast (the table may be bf16)
        if vocab_parallel(self.embed_tokens) is not None:
            return self.embed_tokens(input_ids).to(self.dtype)
        return self.embed_tokens.weight[input_ids].to(self.dtype)

    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """Tied lm_head: hidden @ embed^T -> f32 logits (over this rank's
        vocabulary on a tensor axis)."""
        if self.cfg.weight_quant:
            return self.unembed_q(hidden)
        table = vocab_parallel(self.embed_tokens)
        if table is not None:
            hidden = copy_to_tensor_region(hidden, table.group)
        emb = self.embed_tokens.weight.to(self.dtype)
        if hidden.dtype == torch.float32 or not hidden.is_cuda:
            # bf16 x bf16 products are exact in f32: same as the JAX einsum's
            # preferred_element_type=f32
            return hidden.float() @ emb.float().T
        # bf16 on the card: f32 accumulate and f32 out, without an f32 copy
        # of the [V, D] table
        flat = hidden.reshape(-1, hidden.shape[-1])
        return TiedUnembed.apply(flat, emb).reshape(*hidden.shape[:-1], -1)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,  # [B, Tkv] 1 = valid
        positions: Optional[torch.Tensor] = None,  # [B, T]
        cache: Optional[Tuple] = None,  # per-layer caches
        cache_positions: Optional[torch.Tensor] = None,
        logits_last_only: bool = False,
        dropout_rng: Optional[torch.Generator] = None,  # training: the LoRA dropout's
        return_hidden: bool = False,
        compute_logits: bool = True,  # False: no unembed (logits None), for hidden states only
    ) -> Dict[str, Any]:
        if inputs_embeds is None:
            inputs_embeds = self.embed(input_ids)
        x = inputs_embeds.to(self.dtype)
        b, t = x.shape[:2]
        if positions is None:
            positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
        new_caches = []
        checkpointed = self.cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if checkpointed:
                x, new_c = remat(_layer_state, layer, x, positions, attn_mask, dropout_rng,
                                 rng=dropout_rng), None
            else:
                x, new_c = layer(x, positions, attn_mask,
                                 cache[i] if cache is not None else None, cache_positions,
                                 dropout_rng)
            new_caches.append(new_c)
        x = self.norm(x)
        logits = None
        if compute_logits:
            logits = self.unembed(x[:, -1:] if logits_last_only else x)
        out = {"logits": logits, "cache": tuple(new_caches) if cache is not None else None}
        if return_hidden:
            out["hidden"] = x
        return out

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> Tuple:
        cfg = self.cfg
        shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        dev = self.embed_tokens.weight.device
        return tuple(
            {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev), "index": 0}
            for _ in range(cfg.num_layers)
        )


class TiedUnembed(torch.autograd.Function):
    """The tied unembed's bf16 product with f32 accumulation and f32 logits
    (``torch.mm(..., out_dtype=torch.float32)``, which has no derivative of
    its own): flat [N, D] @ emb [V, D]^T -> [N, V] f32.  The gradient: d flat
    = g @ emb and d emb = g^T @ flat, each with g rounded to the operands'
    type, f32 accumulation, in the operand's type."""

    @staticmethod
    def forward(ctx, flat, emb):
        ctx.save_for_backward(flat, emb)
        return torch.mm(flat, emb.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        flat, emb = ctx.saved_tensors
        g = g.to(emb.dtype)
        d_flat = torch.mm(g, emb, out_dtype=torch.float32).to(flat.dtype) \
            if ctx.needs_input_grad[0] else None
        d_emb = torch.mm(g.T, flat, out_dtype=torch.float32).to(emb.dtype) \
            if ctx.needs_input_grad[1] else None
        return d_flat, d_emb


def cross_entropy_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100,
                          vocab: Optional[VocabParallelEmbedding] = None):
    """HF-style causal LM loss: shift by one, the mean of -log p over the
    label tokens that are not ``ignore_index`` (the softmax in f32).  Returns
    (loss, n_correct, n_valid): argmax hits and the count of valid tokens
    (this rank's).  On a mesh the sum divides by the batch group's count
    (``batch_total``): the rank's share of the global batch's loss.
    ``vocab``: the logits are the rank's columns of that vocab-parallel
    table's; the loss and the argmax (its first index on ties) are the
    whole vocabulary's."""
    shift_logits, shift_labels = logits[:, :-1], labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels)).long()
    if vocab is None:
        logp = torch.log_softmax(shift_logits.float(), dim=-1)
        token_logp = logp.gather(-1, safe[..., None])[..., 0]
        pred = shift_logits.argmax(dim=-1)
    else:
        token_logp, pred = _vocab_parallel_logp(shift_logits, safe, vocab)
    n_valid = valid.sum()
    nll = -torch.where(valid, token_logp, torch.zeros_like(token_logp)).sum()
    loss = nll / batch_total(n_valid).clamp(min=1)
    n_correct = ((pred == shift_labels) & valid).sum()
    return loss, n_correct, n_valid


def _vocab_parallel_logp(logits: torch.Tensor, targets: torch.Tensor,
                         vocab: VocabParallelEmbedding):
    """(log p of ``targets``, the argmax) over the whole vocabulary from the
    rank's columns ``logits``: the max, the sum of exp and the target's
    logit all-reduced over the tensor group (log_softmax's x - max -
    log(sum exp(x - max))); the argmax from each rank's (max, first index),
    the first rank holding the greatest."""
    group, n = vocab.group, logits.shape[-1]
    x = logits.float()
    local = targets - vocab.start
    inside = (local >= 0) & (local < n)
    with torch.no_grad():
        m = x.max(dim=-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        idx = x.argmax(dim=-1)
        best = x.gather(-1, idx[..., None])[..., 0]
        size = dist.get_world_size(group)
        vals = [torch.empty_like(best) for _ in range(size)]
        ids = [torch.empty_like(idx) for _ in range(size)]
        dist.all_gather(vals, best, group=group)
        dist.all_gather(ids, idx + vocab.start, group=group)
        vals, ids = torch.stack(vals), torch.stack(ids)
        first = (vals == vals.max(dim=0).values).to(torch.int32).argmax(dim=0)
        pred = ids.gather(0, first[None])[0]
    total = reduce_from_tensor_region(torch.exp(x - m[..., None]).sum(dim=-1), group)
    picked = x.gather(-1, torch.where(inside, local, torch.zeros_like(local))[..., None])[..., 0]
    target = reduce_from_tensor_region(torch.where(inside, picked, torch.zeros_like(picked)),
                                       group)
    return target - m - torch.log(total), pred


def prefill_split_cache(
    model: LlamaModel,
    inputs_embeds: torch.Tensor,  # [B, T_prompt, D] left-padded
    attn_mask: torch.Tensor,  # [B, T_prompt] 1 = valid
    *,
    num_beams: int,
    max_new_tokens: int,
    ancestry_reorder: bool,
    kv_quant: Optional[str],
    cache_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Tuple, torch.Tensor]:
    """Prefill the prompt at batch B and build the split decode cache:
    (first_logits [B, V], per-layer caches, valid prompt lengths [B]).

    The prompt KV stays at batch B, shared by the beams.  The generated
    segment is [B*K, L, hkv, d] (slots second).  With ``ancestry_reorder`` it
    is never reordered (``anc`` records each slot's source beam; leaves
    ``fixed_*``); ``kv_quant="int8"`` quantizes the prompt once and each
    generated slot at write time.  Without it, ``k``/``v`` are reordered by
    the beam search every step."""
    b, t_prompt, _ = inputs_embeds.shape
    cfg = model.cfg
    dev = inputs_embeds.device
    attn_mask = attn_mask.to(torch.int32)
    cache = model.init_cache(b, t_prompt, dtype=cache_dtype)
    rope_pos = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0)  # HF generate
    slot_pos = torch.arange(t_prompt, device=dev)[None].expand(b, t_prompt)
    out = model(
        inputs_embeds=inputs_embeds, attn_mask=attn_mask, positions=rope_pos, cache=cache,
        cache_positions=slot_pos, logits_last_only=True,
    )
    gen_shape = (b * num_beams, max_new_tokens, cfg.num_kv_heads, cfg.head_dim)
    zeros = functools.partial(torch.zeros, device=dev)

    def split_cache(c):
        entry = {"prompt_k": c["k"], "prompt_v": c["v"], "prompt_mask": attn_mask, "index": 0}
        if not ancestry_reorder:
            entry.update(k=zeros(gen_shape, dtype=cache_dtype), v=zeros(gen_shape, dtype=cache_dtype))
            return entry
        entry["anc"] = zeros((b * num_beams, max_new_tokens), dtype=torch.int32)
        if kv_quant == "int8":
            pk_q, pk_s = quantize_kv(c["k"])
            pv_q, pv_s = quantize_kv(c["v"])
            entry.update(
                prompt_k=pk_q, prompt_v=pv_q, prompt_ks=pk_s, prompt_vs=pv_s,
                fixed_k=zeros(gen_shape, dtype=torch.int8),
                fixed_v=zeros(gen_shape, dtype=torch.int8),
                fixed_ks=zeros(gen_shape[:3], dtype=torch.float32),
                fixed_vs=zeros(gen_shape[:3], dtype=torch.float32),
            )
        else:
            entry.update(fixed_k=zeros(gen_shape, dtype=cache_dtype),
                         fixed_v=zeros(gen_shape, dtype=cache_dtype))
        return entry

    caches = tuple(split_cache(c) for c in out["cache"])
    return out["logits"][:, -1], caches, attn_mask.sum(dim=1)


def decode_step(model: LlamaModel, tokens, positions, cache):
    """One decoder token for every beam row: (logits [B*K, V], cache)."""
    o = model(input_ids=tokens, attn_mask=None, positions=positions, cache=cache)
    return o["logits"][:, -1], o["cache"]


def prefill_full_cache(
    model: LlamaModel,
    inputs_embeds: torch.Tensor,  # [B, T_prompt, D] left-padded
    attn_mask: torch.Tensor,  # [B, T_prompt] 1 = valid
    *,
    num_beams: int,
    max_new_tokens: int,
    cache_dtype=torch.bfloat16,
):
    """``share_prompt_kv=False``: prefill the prompt into a cache of
    T_prompt + L slots at batch B, then tile it to the beams.  Returns
    (first_logits [B, V], per-layer caches with leaves [B*K, hkv, T+L, d],
    decode_fn, valid prompt lengths [B]); every decode step attends over the
    prompt mask and the generated slots written so far (``cache_positions``
    = the write slot)."""
    b, t_prompt, _ = inputs_embeds.shape
    k, gen = num_beams, max_new_tokens
    dev = inputs_embeds.device
    attn_mask = attn_mask.to(torch.int32)
    cache = model.init_cache(b, t_prompt + gen, dtype=cache_dtype)
    rope_pos = torch.clamp(torch.cumsum(attn_mask, dim=1) - 1, min=0)  # HF generate
    slot_pos = torch.arange(t_prompt, device=dev)[None].expand(b, t_prompt)
    prefill_mask = torch.cat([attn_mask, torch.zeros(b, gen, dtype=torch.int32, device=dev)], 1)
    out = model(
        inputs_embeds=inputs_embeds, attn_mask=prefill_mask, positions=rope_pos, cache=cache,
        cache_positions=slot_pos, logits_last_only=True,
    )
    caches = tuple(
        {"k": c["k"].repeat_interleave(k, dim=0), "v": c["v"].repeat_interleave(k, dim=0),
         "index": c["index"]}
        for c in out["cache"]
    )
    prompt_mask_k = attn_mask.repeat_interleave(k, dim=0)  # [B*K, T_prompt]
    gen_slot_ids = torch.arange(gen, device=dev)[None, :]

    def decode_fn(tokens, positions, cache):
        idx = cache[0]["index"]  # the next write slot
        gen_mask = (gen_slot_ids <= idx - t_prompt).to(torch.int32).expand(b * k, gen)
        slot = torch.full((b * k, 1), idx, dtype=torch.long, device=dev)
        o = model(input_ids=tokens, attn_mask=torch.cat([prompt_mask_k, gen_mask], dim=1),
                  positions=positions, cache=cache, cache_positions=slot)
        return o["logits"][:, -1], o["cache"]

    return out["logits"][:, -1], caches, decode_fn, attn_mask.sum(dim=1)


def generate_beam(
    model: Union[LlamaModel, Sequence[LlamaModel]],
    inputs_embeds: Union[torch.Tensor, Sequence[torch.Tensor]],  # [B, T_prompt, D] left-padded
    attn_mask: Union[torch.Tensor, Sequence[torch.Tensor]],  # [B, T_prompt] 1 = valid
    *,
    eos_token_id: int,
    pad_token_id: int,
    num_beams: int = 5,
    max_new_tokens: int = 100,
    length_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
    cache_dtype=torch.bfloat16,
    share_prompt_kv: bool = True,
    ancestry_reorder: bool = False,
    kv_quant: Optional[str] = None,
    constraints=None,
    constraints_mode: str = "unordered",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-generate-equivalent beam search over embedded prompts; returns
    (sequences [B, K, max_new_tokens], scores [B, K]).

    The cache is the split cache (``share_prompt_kv=True``: the ancestry
    decode with an int8, bf16 or f32 KV cache, or the gather reorder), or a
    full per-beam cache of T + L slots (``share_prompt_kv=False``).

    An ensemble passes equal-length lists of models, embeddings and masks (a
    single tensor is shared by every member): each member prefills its own
    prompt, which may differ in length, and every step averages the members'
    normalised log-probs, ``logsumexp - log n`` (fairseq's EnsembleModel).
    ``constraints`` (``ops.constraints.TrieArrays`` or ``SequenceArrays``)
    runs ``constrained_beam_search``; not with an ensemble."""
    if kv_quant and not (ancestry_reorder and share_prompt_kv):
        raise ValueError("kv_quant requires ancestry_reorder (split cache)")
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    lists = [x for x in (model, inputs_embeds, attn_mask) if isinstance(x, (list, tuple))]
    n_ens = len(lists[0]) if lists else 1
    if any(len(x) != n_ens for x in lists):
        raise ValueError("ensemble models, embeddings and masks must have one length")
    ens = [list(x) if isinstance(x, (list, tuple)) else [x] * n_ens
           for x in (model, inputs_embeds, attn_mask)]
    k = num_beams

    def prefill(member, emb, mask):
        if not share_prompt_kv:
            return prefill_full_cache(member, emb, mask, num_beams=k,
                                      max_new_tokens=max_new_tokens, cache_dtype=cache_dtype)
        first, cache, lens = prefill_split_cache(
            member, emb, mask, num_beams=k, max_new_tokens=max_new_tokens,
            ancestry_reorder=ancestry_reorder, kv_quant=kv_quant, cache_dtype=cache_dtype)
        return first, cache, functools.partial(decode_step, member), lens

    members = [prefill(*m) for m in zip(*ens)]
    search = dict(eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                  max_new_tokens=max_new_tokens, num_beams=k, length_penalty=length_penalty)
    if constraints is not None:
        if n_ens != 1:
            raise NotImplementedError("constrained decoding with ensembles")
        first_logits, cache_k, decode_fn, valid_lens = members[0]
        return constrained_beam_search(
            decode_fn, cache_k, prompt_lengths=valid_lens, first_logits=first_logits,
            constraint_set=constraints, mode=constraints_mode, **search)
    if n_ens == 1:
        first_logits, cache_k, decode_fn, valid_lens = members[0]
        return beam_search(decode_fn, cache_k, prompt_lengths=valid_lens,
                           first_logits=first_logits,
                           no_repeat_ngram_size=no_repeat_ngram_size, **search)

    lens0 = members[0][3]
    log_n = math.log(n_ens)
    ens_first = torch.logsumexp(
        torch.stack([log_softmax(m[0].float()) for m in members]), dim=0) - log_n

    def ens_decode(tokens, positions, caches):
        # positions arrive relative to member 0's prompt lengths
        logps, new_caches = [], []
        for (_, _, dfn, lens), cache in zip(members, caches):
            off = (lens - lens0).repeat_interleave(k)[:, None]
            lg, nc = dfn(tokens, positions + off, cache)
            logps.append(log_softmax(lg.float()))
            new_caches.append(nc)
        return torch.logsumexp(torch.stack(logps), dim=0) - log_n, tuple(new_caches)

    return beam_search(ens_decode, tuple(m[1] for m in members), prompt_lengths=lens0,
                       first_logits=ens_first, no_repeat_ngram_size=no_repeat_ngram_size,
                       **search)


_ATTN_PROJ = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP_PROJ = ("gate_proj", "up_proj", "down_proj")
# the float weights that weight quantization replaces, from the same name
# lists as quantize_llama_
_QUANT_KEY = re.compile(rf"(layers_\d+\.(?:self_attn\.(?:{'|'.join(_ATTN_PROJ)})\.base"
                        rf"|mlp\.(?:{'|'.join(_MLP_PROJ)})))\.weight")


# ---- the pipeline-parallel training forward ---------------------------------------


def stack_layer_params(layers: Sequence[nn.Module], num_layers: int,
                       n_stages: int) -> List[List[nn.Module]]:
    """The decoder layers as P stages of L / P consecutive layers: stage s
    holds layers s * L / P ... (s + 1) * L / P - 1 (the JAX function stacks
    their parameters on a leading [P, L / P] axis)."""
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers not divisible into {n_stages} stages")
    per = num_layers // n_stages
    return [list(layers[s * per:(s + 1) * per]) for s in range(n_stages)]


_STREAM = 1_000_003


def stream_seed(base: int, *index: int) -> int:
    """A dropout stream's seed from ``base`` and (stage, microbatch, batch
    group, layer)."""
    for i in index:
        base = (base * _STREAM + i) % (2 ** 63)
    return base


def pipeline_lm_forward(model: "LlamaModel", inputs_embeds: torch.Tensor,
                        attn_mask: Optional[torch.Tensor], mesh, n_microbatches: int,
                        dropout_seed: Optional[int] = None) -> torch.Tensor:
    """The training forward with the decoder layers split over the mesh's
    pipeline axis (GPipe, ``parallel/pipeline.py: pipeline_apply``): this
    rank runs its stage's layers on the ``n_microbatches`` microbatches of
    its batch, the positions and the mask riding with each; every stage then
    runs the final norm and the tied unembed on the broadcast output.
    Returns f32 logits [B, T, V].  ``dropout_seed`` draws the LoRA dropout,
    one stream for each (stage, microbatch, batch group, layer); None is the
    deterministic forward."""
    cfg = model.cfg
    n_stages = mesh.size("pipeline") if mesh is not None else 1
    stage = mesh.coords["pipeline"] if mesh is not None else 0
    b, t, _ = inputs_embeds.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} microbatches")
    x = inputs_embeds.to(model.dtype)
    positions = microbatch(torch.arange(t, device=x.device)[None, :].expand(b, t), n_microbatches)
    mask = attn_mask if attn_mask is not None else torch.ones((b, t), dtype=torch.int32,
                                                            device=x.device)
    mask = microbatch(mask, n_microbatches)
    layers = stack_layer_params(model.layers, cfg.num_layers, n_stages)[stage]
    group = batch_group_rank(mesh)

    def stage_fn(h, mb):
        for li, layer in enumerate(layers):
            rng = None
            if dropout_seed is not None:
                rng = torch.Generator(device=h.device).manual_seed(
                    stream_seed(dropout_seed, stage, mb, group, li))
            h, _ = layer(h, positions[mb], mask[mb], dropout_rng=rng)
        return h

    params = [p for layer in layers for p in layer.parameters() if p.requires_grad]
    h = unmicrobatch(pipeline_apply(stage_fn, params, microbatch(x, n_microbatches), mesh))
    return model.unembed(model.norm(h))


def quantize_llama_params(
    params: Union[Mapping[str, torch.Tensor], LlamaModel], mode: str = "int8",
) -> Dict[str, torch.Tensor]:
    """Float LLaMA state_dict (or module) -> the weight-quantized serving
    state_dict that a ``LlamaModel`` with ``weight_quant=mode`` loads; the JAX
    ``quantize_llama_params`` on the port's keys.

    Every attention projection's base (``.base.weight`` -> ``.base_q.*``)
    and every MLP weight becomes ``w_q``/``w_scale`` (int8) or
    ``w_packed``/``w_scale`` (int4) in the flax [d_in, d_out] layout;
    ``unembed_q`` is the quantized copy of embed^T for the tied lm_head; the
    table kept for the input gather drops to bf16.  LoRA factors and norms
    stay as they are."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    emb = params["embed_tokens.weight"]  # [V, D]: the [out, in] weight of the unembed
    out = {f"unembed_q.{k}": v for k, v in quantize_weight(emb, mode).items()}
    for key, val in params.items():
        if key == "embed_tokens.weight":
            out[key] = val.to(torch.bfloat16)
            continue
        match = _QUANT_KEY.fullmatch(key)
        if match is None:
            out[key] = val
            continue
        prefix = re.sub(r"\.base$", ".base_q", match.group(1))
        out.update({f"{prefix}.{k}": v for k, v in quantize_weight(val, mode).items()})
    return out


@torch.no_grad()
def quantize_llama_(model: LlamaModel, mode: str = "int8") -> LlamaModel:
    """Quantize a float ``model`` in place on its device, to the layout of
    ``quantize_llama_params``.  Each float weight is released as soon as its
    quantized copy exists, so the float and the quantized trunk are never
    resident together."""
    if model.cfg.weight_quant:
        raise ValueError(f"the model is already quantized ({model.cfg.weight_quant})")
    cfg = dataclasses.replace(model.cfg, weight_quant=mode)
    for layer in model.layers:
        for name in _ATTN_PROJ:
            getattr(layer.self_attn, name).quantize_(mode)
        for name in _MLP_PROJ:
            lin = getattr(layer.mlp, name)
            setattr(layer.mlp, name, QuantDense.from_weight(lin.weight, mode, lin.weight.dtype))
        layer.self_attn.cfg = cfg
    model.unembed_q = QuantDense.from_weight(model.embed_tokens.weight, mode, torch.float32)
    model.embed_tokens.to(torch.bfloat16)
    model.cfg = cfg
    return model


# ---- the HF weight import ---------------------------------------------------------


def import_hf_llama(state: Mapping, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """An HF ``LlamaModel`` / ``LlamaForCausalLM`` state dict (keys under
    ``""``, ``model.`` or ``base_model.model.model.``) as ``LlamaModel``'s
    float state dict; the [out, in] weights cross as they are.

    With ``cfg.lora``, each targeted projection gets fresh adapters, drawn
    as the JAX import draws them: a new ``np.random.default_rng(0)`` for
    every projection, ``lora_a`` ~ U(-sqrt(6 / in), sqrt(6 / in)) of shape
    [in, r] in f32, and ``lora_b`` = 0, so the imported model is exact at
    load."""

    def get(k):
        for p in ("", "model.", "base_model.model.model."):
            if p + k in state:
                return as_tensor(state[p + k])
        raise KeyError(k)

    out: Dict[str, torch.Tensor] = {"embed_tokens.weight": get("embed_tokens.weight"),
                                    "norm.weight": get("norm.weight")}
    for i in range(cfg.num_layers):
        src, dst = f"layers.{i}", f"layers_{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            out[f"{dst}.{norm}.weight"] = get(f"{src}.{norm}.weight")
        for name in _ATTN_PROJ:
            w = get(f"{src}.self_attn.{name}.weight")
            out[f"{dst}.self_attn.{name}.base.weight"] = w
            if cfg.lora and name in cfg.lora.targets:
                d_out, d_in = w.shape
                bound = math.sqrt(6.0 / d_in)
                rng = np.random.default_rng(0)
                out[f"{dst}.self_attn.{name}.lora_a"] = torch.from_numpy(
                    rng.uniform(-bound, bound, (d_in, cfg.lora.rank)).astype(np.float32))
                out[f"{dst}.self_attn.{name}.lora_b"] = torch.zeros(cfg.lora.rank, d_out)
        for name in _MLP_PROJ:
            out[f"{dst}.mlp.{name}.weight"] = get(f"{src}.mlp.{name}.weight")
    return out
