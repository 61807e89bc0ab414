"""Beam-decode attention over the split int8 KV cache: K2 and K3.

Port of ``multimodalvc_tpu/ops/decode_attention.py``.  The generated
segment of the cache is never reordered: ``anc [B*K, L]`` records, per
(row, slot), which beam row of the same batch element holds that slot's
key/value, and ``gen_attention_ancestor`` selects by it.  Both kernels
return softmax partials (unnormalised f32 out, row max m, row sum l) that
``merge_softmax_segments`` combines.

For CUDA tensors ``prompt_attention`` and ``gen_attention_ancestor`` launch
``csrc/decode_attention.cu`` (bf16 queries; int8 KV with f32 scales, or bf16
KV with none); for CPU tensors they run the plain versions below, which
follow the JAX ``prompt_attention_ref`` / ``gen_attention_ancestor_ref``
oracles.  Each wrapper counts its int8 launches in ``launches`` and its bf16
launches in ``launches_bf16``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from . import kernel_lib

NEG = -1e30

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 over the trailing (head_dim) axis:
    [..., d] -> (int8 [..., d], f32 scale [...]).  Rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def merge_softmax_segments(out_a, m_a, l_a, out_b, m_b, l_b) -> torch.Tensor:
    """Combine two segments' (weighted-V, max, normaliser) partials into the
    final attention output: the flash-attention two-block merge."""
    m = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m)[..., None]
    cb = torch.exp(m_b - m)[..., None]
    num = out_a * ca + out_b * cb
    den = (l_a * torch.exp(m_a - m) + l_b * torch.exp(m_b - m))[..., None]
    return num / torch.clamp(den, min=1e-30)


def _dequant(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def prompt_attention_plain(
    q, prompt_k, prompt_v, prompt_mask, *, beams, scale, k_scale=None, v_scale=None
) -> Partials:
    """Plain version of K2 (the JAX ``prompt_attention_ref``)."""
    rows, h, d = q.shape
    b, g, tp, _ = prompt_k.shape
    rep = h // g
    k = _dequant(prompt_k, k_scale)
    v = _dequant(prompt_v, v_scale)
    qb = q.reshape(b, beams, g, rep, d).float()
    s = torch.einsum("bkgrd,bgpd->bkgrp", qb, k) * scale
    ok = prompt_mask.bool()[:, None, None, None, :]
    s = torch.where(ok, s, NEG)
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    lsum = p.sum(dim=-1)
    out = torch.einsum("bkgrp,bgpd->bkgrd", p, v)
    return out.reshape(rows, h, d), m.reshape(rows, h), lsum.reshape(rows, h)


def gen_attention_ancestor_plain(
    q, gen_k, gen_v, anc, valid_len, *, beams, scale, k_scale=None, v_scale=None
) -> Partials:
    """Plain version of K3 (the JAX ``gen_attention_ancestor_ref``)."""
    rows, h, d = q.shape
    _, slots, g, _ = gen_k.shape
    b = rows // beams
    rep = h // g
    kb = _dequant(gen_k, k_scale).reshape(b, beams, slots, g, d)
    vb = _dequant(gen_v, v_scale).reshape(b, beams, slots, g, d)
    ab = anc.reshape(b, beams, slots).long()
    qb = q.reshape(b, beams, g, rep, d).float()
    # key/value of slot l for query beam k: source beam anc[b, k, l]
    idx = ab[..., None, None].expand(b, beams, slots, g, d)
    k_sel = torch.gather(kb, 1, idx)  # [b, Kq, L, g, d]
    v_sel = torch.gather(vb, 1, idx)
    sel = torch.einsum("bqgrd,bqlgd->bqgrl", qb, k_sel) * scale
    ok = torch.arange(slots, device=q.device) < valid_len
    sel = torch.where(ok, sel, NEG)
    m = sel.amax(dim=-1)
    p = torch.where(ok, torch.exp(sel - m[..., None]), 0.0)
    lsum = p.sum(dim=-1)
    out = torch.einsum("bqgrl,bqlgd->bqgrd", p, v_sel)
    return out.reshape(rows, h, d), m.reshape(rows, h), lsum.reshape(rows, h)


def _partials_out(q: torch.Tensor) -> Partials:
    rows, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return torch.empty(rows, h, d, **f32), torch.empty(rows, h, **f32), torch.empty(rows, h, **f32)


def _check_kv(k, v, k_scale, v_scale, shape, name: str) -> bool:
    """Validate the KV operands of K2/K3; True for a bf16 cache."""
    bf16 = k_scale is None and v_scale is None
    if not bf16 and (k_scale is None or v_scale is None):
        raise ValueError(f"{name} kernel: give both k_scale and v_scale, or neither")
    kv_type = torch.bfloat16 if bf16 else torch.int8
    kernel_lib.check(k, f"{name} k", kv_type, shape)
    kernel_lib.check(v, f"{name} v", kv_type, shape)
    if not bf16:
        kernel_lib.check(k_scale, f"{name} k_scale", torch.float32, shape[:3])
        kernel_lib.check(v_scale, f"{name} v_scale", torch.float32, shape[:3])
    return bf16


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def prompt_attention(
    q: torch.Tensor,  # [B*K, h, d]
    prompt_k: torch.Tensor,  # [B, g, Tp, d] int8 or bf16
    prompt_v: torch.Tensor,
    prompt_mask: torch.Tensor,  # [B, Tp] nonzero = valid
    *,
    beams: int,
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # [B, g, Tp] f32 for int8 KV
    v_scale: Optional[torch.Tensor] = None,
) -> Partials:
    """Shared-prompt segment softmax partials (out [B*K,h,d], m, l [B*K,h]).

    CUDA tensors run K2: bf16 q, int8 K/V with f32 scales or bf16 K/V
    without, int32 mask."""
    if q.device.type == "cpu":
        return prompt_attention_plain(
            q, prompt_k, prompt_v, prompt_mask, beams=beams, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    rows, h, d = q.shape
    b, g, tp, _ = prompt_k.shape
    kernel_lib.check(q, "q", torch.bfloat16, (b * beams, h, d))
    bf16 = _check_kv(prompt_k, prompt_v, k_scale, v_scale, (b, g, tp, d), "prompt_attention")
    kernel_lib.check(prompt_mask, "prompt_mask", torch.int32, (b, tp))
    out, m, l = _partials_out(q)
    kernel_lib.load().call(
        "mmvc_prompt_attention", q.data_ptr(), prompt_k.data_ptr(), prompt_v.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), prompt_mask.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, beams, h, g, tp, d, float(scale), int(bf16), kernel_lib.stream_ptr(q),
    )
    if bf16:
        prompt_attention.launches_bf16 += 1
    else:
        prompt_attention.launches += 1
    return out, m, l


prompt_attention.launches = 0
prompt_attention.launches_bf16 = 0


def gen_attention_ancestor(
    q: torch.Tensor,  # [B*K, h, d]
    gen_k: torch.Tensor,  # [B*K, L, g, d] int8 or bf16
    gen_v: torch.Tensor,
    anc: torch.Tensor,  # [B*K, L] int32, values 0..K-1 (within-batch rows)
    valid_len: Union[int, torch.Tensor],
    *,
    beams: int,
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # [B*K, L, g] f32 for int8 KV
    v_scale: Optional[torch.Tensor] = None,
) -> Partials:
    """Softmax partials of the ancestry-selected generated segment:
    s_l = scale * q . k_(anc_l, l) for slots l < valid_len.  valid_len == 0
    gives (0, -1e30, 0), a no-op segment for the merge.

    CUDA tensors run K3: bf16 q, int8 K/V with f32 scales or bf16 K/V
    without, int32 anc."""
    if q.device.type == "cpu":
        return gen_attention_ancestor_plain(
            q, gen_k, gen_v, anc, valid_len, beams=beams, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    rows, h, d = q.shape
    _, slots, g, _ = gen_k.shape
    kernel_lib.check(q, "q", torch.bfloat16, (rows, h, d))
    bf16 = _check_kv(gen_k, gen_v, k_scale, v_scale, (rows, slots, g, d), "gen_attention_ancestor")
    kernel_lib.check(anc, "anc", torch.int32, (rows, slots))
    if rows % beams:
        raise ValueError(f"gen_attention_ancestor: {rows} rows not a multiple of {beams} beams")
    out, m, l = _partials_out(q)
    kernel_lib.load().call(
        "mmvc_gen_attention_ancestor", q.data_ptr(), gen_k.data_ptr(), gen_v.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), anc.data_ptr(), int(valid_len),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        rows // beams, beams, h, g, slots, d, float(scale), int(bf16), kernel_lib.stream_ptr(q),
    )
    if bf16:
        gen_attention_ancestor.launches_bf16 += 1
    else:
        gen_attention_ancestor.launches += 1
    return out, m, l


gen_attention_ancestor.launches = 0
gen_attention_ancestor.launches_bf16 = 0
