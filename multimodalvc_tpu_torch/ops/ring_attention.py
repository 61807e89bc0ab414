"""Ring attention: sequence-parallel exact attention over the mesh
"sequence" axis.

Port of ``multimodalvc_tpu/ops/ring_attention.py``.  Each rank of the
sequence group holds T / S of q, k and v along time; the k / v blocks travel
round the ring (``parallel/collectives.py: ring_shift``, one exchange of the
stacked pair a step, its gradient travelling back), and the exact softmax
accumulates through the (m, l, acc) recurrence of ``_block_attn``, with the
causal and ``kv_len`` masks at global positions.  No [T, T] scores are
formed.  The block step stays plain PyTorch: the JAX one is plain JAX, not a
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..parallel.collectives import ring_shift

NEG_INF = -1e30


def _block_attn(q, k, v, scale, q_off, kv_off, kv_valid, causal):
    """One ring step: the local q against one k / v block.  q: [B,H,Tq,D],
    k / v: [B,H,Tk,D], ``kv_valid`` [B,1,1,1]; returns the block's (m, l, acc)
    in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    tk = k.shape[2]
    kv_ids = kv_off + torch.arange(tk, device=q.device)[None, None, None, :]
    valid = kv_ids < kv_valid
    if causal:
        q_ids = q_off + torch.arange(q.shape[2], device=q.device)[None, None, :, None]
        valid = valid & (kv_ids <= q_ids)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return m, l, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "sequence", kv_len: Optional[torch.Tensor] = None,
                   causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this rank's time chunk: q / k / v [B, H, T/S, D]
    are the chunks at position ``mesh.coords[axis]`` of the global [B, H, T,
    D]; ``kv_len`` (a scalar or [B]) the global valid lengths.  Returns this
    chunk's output [B, H, T/S, D] in q's dtype."""
    n, idx = mesh.size(axis), mesh.coords[axis]
    b, h, chunk, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv_len is None:
        kv_len = torch.full((b,), n * chunk, dtype=torch.int32, device=q.device)
    kv_len = torch.as_tensor(kv_len, device=q.device).to(torch.int32).expand(b)
    kv_valid = kv_len[:, None, None, None]
    group = mesh.group(axis)
    to_rank = mesh.rank_of(**{axis: (idx + 1) % n})
    from_rank = mesh.rank_of(**{axis: (idx - 1) % n})
    m_run = torch.full((b, h, chunk, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, h, chunk, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, chunk, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        # the block resident now came from rank (idx - i) mod n
        src = (idx - i) % n
        m_b, l_b, acc_b = _block_attn(q, kv[0], kv[1], scale, idx * chunk, src * chunk,
                                      kv_valid, causal)
        m_new = torch.maximum(m_run, m_b)
        alpha, beta = torch.exp(m_run - m_new), torch.exp(m_b - m_new)
        l_run = l_run * alpha + l_b * beta
        acc = acc * alpha + acc_b * beta
        m_run = m_new
        if i < n - 1:
            kv = ring_shift(kv, group, to_rank, from_rank)
    return (acc / torch.clamp(l_run, min=1e-30)).to(q.dtype)
