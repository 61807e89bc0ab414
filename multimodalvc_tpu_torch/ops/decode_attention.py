"""Beam-decode attention over the split int8 KV cache: K2, K3 and their merge.

Port of ``multimodalvc_tpu/ops/decode_attention.py``.  The generated
segment of the cache is never reordered: ``anc [B*K, L]`` records, per
(row, slot), which beam row of the same batch element holds that slot's
key/value, and ``gen_attention_ancestor`` selects by it.  Both kernels
return softmax partials (unnormalised f32 out, row max m, row sum l) that
``merge_softmax_segments`` combines; ``ancestry_attention`` is the two and
their merge in one launch, cast to the model dtype, as the JAX decode step
computes it (``multimodalvc_tpu/nn/llama.py:342-377``).

For CUDA tensors the three wrappers launch the entries of one split-KV
kernel template, ``csrc/decode_attention.cu``, on the schedule of
``decode_plan`` (bf16 queries; int8 KV with f32 scales, or bf16 KV with none
for K2/K3; int8 for the merged entry); for CPU tensors they run the plain
versions below, which follow the JAX ``prompt_attention_ref`` /
``gen_attention_ancestor_ref`` oracles and ``merge_softmax_segments``.  K2
and K3 count their int8 launches in ``launches`` and their bf16 launches in
``launches_bf16``; the merged entry in ``launches``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

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


def ancestry_attention_plain(
    q, prompt_k, prompt_v, prompt_mask, gen_k, gen_v, anc, valid_len, *, beams, scale,
    prompt_k_scale=None, prompt_v_scale=None, gen_k_scale=None, gen_v_scale=None,
    out_dtype=None,
) -> torch.Tensor:
    """Plain version of the merged entry: the two plain partials, merged,
    then cast to ``out_dtype`` (default q's type), in the JAX decode's op
    order."""
    part_p = prompt_attention_plain(q, prompt_k, prompt_v, prompt_mask, beams=beams, scale=scale,
                                    k_scale=prompt_k_scale, v_scale=prompt_v_scale)
    part_g = gen_attention_ancestor_plain(q, gen_k, gen_v, anc, valid_len, beams=beams,
                                          scale=scale, k_scale=gen_k_scale, v_scale=gen_v_scale)
    return merge_softmax_segments(*part_p, *part_g).to(out_dtype or q.dtype)


# ---- the kernel's schedule -----------------------------------------------------

# csrc/decode_attention.cu: head dim 128; the K * rep query rows of one kv
# head in 16-row tiles, one after another in the block; at most 128 key rows
# a chunk (prompt slots, or K sources x generated slots rounded up to 16; one
# slot of every source past 128 beams, and past ``decode_max_beams()`` one
# slot of a piece of the sources, ``gen_chunk_beams``); the blocks of one
# (batch element, kv head) form one cluster of at most 8, block r taking
# chunks r, r + splits, ...  The plan, timed on the H100 by ``chip_smoke.py --plans``
# (PERF.md): while the grid is small, the smallest chunks of the options
# below that number at most 7 (a cluster of 8 ran slower than one of 7): K3
# alone at batch 8 takes 6 chunks of 15 keys, the merged entry 3 prompt
# chunks of 48 slots and 2 generated chunks of 40 keys; a larger grid takes
# chunks of up to 80 or 128, and fewer blocks than chunks once it passes
# DECODE_TARGET_BLOCKS (at batch 48, 3 blocks for 6 chunks).
DECODE_HEAD_DIM, DECODE_ROWS, DECODE_MAX_KEYS, DECODE_MAX_SPLITS = 128, 16, 128, 7
DECODE_TARGET_BLOCKS = 8 * 132
DECODE_SMEM_MAX = 232448  # 227 KB a block
# (prompt slots, generated keys) a chunk at most, smallest first; the first
# two serve small grids only
_CHUNK_OPTIONS = ((48, 15), (48, 40), (80, 80), (128, 128))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class DecodePlan(NamedTuple):
    prompt_slots: int  # slots a prompt chunk, a multiple of 16 (0: no prompt segment)
    prompt_chunks: int
    gen_slots: int  # generated slots a chunk, read from every source beam (0: no segment)
    gen_chunks: int
    splits: int  # blocks (one cluster) a (batch element, kv head); the grid is (splits, g, B)

    @property
    def chunks(self) -> int:
        return self.prompt_chunks + self.gen_chunks


def decode_smem_bytes(keys: int, kv_bytes: int, merged: bool, preds: int = 0) -> int:
    """Shared memory of one block (``Smem`` in ``csrc/decode_attention.cu``)
    for chunks of at most ``keys`` key rows of ``kv_bytes``-byte elements:
    the running statistics and the combine's buffers, the key and value
    tiles, the scores of one 16-row tile, the scales and the validity
    entries (at least ``preds``: a generated chunk's ancestor of every query
    beam), and the merged entry's f32 q."""
    d, rows, splits = DECODE_HEAD_DIM, DECODE_ROWS, DECODE_MAX_SPLITS + 1
    s_pitch = _cdiv(keys, 32) * 32 + 16
    fixed = 4 * rows * 4 + splits * 2 * rows * 4 + (rows * d // 4 + splits) * 16
    tiles = (keys * ((d + 16) * kv_bytes + d * kv_bytes + 16) + rows * s_pitch * 4 + keys * 8
             + max(keys, _cdiv(preds, 4) * 4) * 4)
    return fixed + tiles + (rows * (d + 4) * 4 if merged else 0)


def _balanced(slots: int, most: int, step: int) -> Tuple[int, int]:
    """(slots a chunk, chunks): the fewest chunks of at most ``most`` slots,
    sized evenly and rounded up to ``step``; (0, 0) for no slots."""
    if slots == 0:
        return 0, 0
    size = _cdiv(_cdiv(slots, _cdiv(slots, most)), step) * step
    return size, _cdiv(slots, size)


@functools.lru_cache(maxsize=None)  # a decode step asks for the same shape in every layer
def decode_plan(batch: int, beams: int, heads: int, kv_heads: int, head_dim: int,
                prompt_slots: int, gen_slots: int) -> DecodePlan:
    """The chunks and splits of the split-KV kernel for a decode step of
    ``batch`` x ``beams`` rows against ``prompt_slots`` shared prompt slots
    and ``gen_slots`` generated slots (either 0 for the K3 or the K2 entry
    alone), for any number of query rows a kv head (the kernel takes them in
    16-row tiles).  It depends on the shapes only, never on ``valid_len``,
    so one grid serves every step.  Raises ValueError for what the kernel
    cannot take."""
    rep = heads // kv_heads if kv_heads > 0 else 0
    why = None
    if head_dim != DECODE_HEAD_DIM:
        why = f"head dim {head_dim} (the kernel takes {DECODE_HEAD_DIM})"
    elif kv_heads <= 0 or heads % kv_heads or beams <= 0 or beams * rep >= 2 ** 16:
        why = f"{beams} beams x {heads}/{kv_heads} heads"
    elif batch <= 0 or batch > 65535 or kv_heads > 65535:
        why = f"batch {batch} x {kv_heads} kv heads (at most 65535 each)"
    elif prompt_slots < 0 or gen_slots < 0 or prompt_slots + gen_slots == 0:
        why = f"{prompt_slots} prompt and {gen_slots} generated slots"
    if why is not None:
        raise ValueError(f"decode attention kernel: {why}")
    pairs = batch * kv_heads
    pieces = _cdiv(beams, gen_chunk_beams(beams))  # generated chunks a slot range
    options = _CHUNK_OPTIONS if pairs * DECODE_MAX_SPLITS <= DECODE_TARGET_BLOCKS else \
        _CHUNK_OPTIONS[2:]
    for most_p, most_keys in options:
        cp, pc = _balanced(prompt_slots, most_p, 16)
        cg, gc = _balanced(gen_slots, max(1, most_keys // beams), 1)
        gc *= pieces
        if pc + gc <= DECODE_MAX_SPLITS:
            break
    splits = min(pc + gc, DECODE_MAX_SPLITS, _cdiv(DECODE_TARGET_BLOCKS, pairs))
    return DecodePlan(cp, pc, cg, gc, splits)


@functools.lru_cache(maxsize=None)
def decode_max_beams() -> int:
    """The most beams whose generated chunk of one slot holds every source
    beam (bf16 KV, the largest elements): its K key rows, rounded up to 16,
    in 227 KB.  Past it a slot's sources are read in pieces
    (``gen_chunk_beams``)."""
    keys = DECODE_MAX_KEYS
    while decode_smem_bytes(keys + 16, 2, False) <= DECODE_SMEM_MAX:
        keys += 16
    return keys


@functools.lru_cache(maxsize=None)
def gen_chunk_beams(beams: int) -> int:
    """The source beams of a generated chunk: all ``beams`` up to
    ``decode_max_beams()``; past it one slot of a piece of them, the pieces
    even and rounded up to 16, each chunk's key rows with the ancestors of
    every query beam within 227 KB in both KV types (``decode_plan``'s
    generated chunks then number ceil(beams / pieces) a slot)."""
    if beams <= decode_max_beams():
        return beams
    most = 16
    while all(decode_smem_bytes(most + 16, kv_bytes, merged, beams) <= DECODE_SMEM_MAX
              for kv_bytes, merged in ((2, False), (1, True))):
        most += 16
    return _cdiv(_cdiv(beams, _cdiv(beams, most)), 16) * 16


# ---- the kernel wrappers -----------------------------------------------------


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

    CUDA tensors run K2 on ``decode_plan``'s prompt chunks: bf16 q, int8 K/V
    with f32 scales or bf16 K/V without, int32 mask."""
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
    plan = decode_plan(b, beams, h, g, d, tp, 0)
    out, m, l = _partials_out(q)
    kernel_lib.load().call(
        "mmvc_prompt_attention", q.data_ptr(), prompt_k.data_ptr(), prompt_v.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), prompt_mask.data_ptr(), out.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, beams, h, g, tp, d, plan.prompt_slots, plan.prompt_chunks, plan.splits,
        float(scale), int(bf16), kernel_lib.stream_ptr(q),
    )
    if bf16:
        prompt_attention.launches_bf16 += 1
    else:
        prompt_attention.launches += 1
    return out, m, l


prompt_attention.launches = 0
prompt_attention.launches_bf16 = 0


def _check_gen(q, gen_k, gen_v, anc, k_scale, v_scale, beams: int, name: str) -> bool:
    """Validate K3's operands (q, the generated KV, anc); True for bf16 KV."""
    rows, h, d = q.shape
    _, slots, g, _ = gen_k.shape
    kernel_lib.check(q, "q", torch.bfloat16, (rows, h, d))
    bf16 = _check_kv(gen_k, gen_v, k_scale, v_scale, (rows, slots, g, d), name)
    kernel_lib.check(anc, "anc", torch.int32, (rows, slots))
    if rows % beams:
        raise ValueError(f"{name}: {rows} rows not a multiple of {beams} beams")
    return bf16


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

    CUDA tensors run K3 on ``decode_plan``'s generated chunks: bf16 q, int8
    K/V with f32 scales or bf16 K/V without, int32 anc."""
    if q.device.type == "cpu":
        return gen_attention_ancestor_plain(
            q, gen_k, gen_v, anc, valid_len, beams=beams, scale=scale,
            k_scale=k_scale, v_scale=v_scale,
        )
    bf16 = _check_gen(q, gen_k, gen_v, anc, k_scale, v_scale, beams, "gen_attention_ancestor")
    rows, h, d = q.shape
    _, slots, g, _ = gen_k.shape
    plan = decode_plan(rows // beams, beams, h, g, d, 0, slots)
    out, m, l = _partials_out(q)
    kernel_lib.load().call(
        "mmvc_gen_attention_ancestor", q.data_ptr(), gen_k.data_ptr(), gen_v.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), anc.data_ptr(), int(valid_len), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), rows // beams, beams, h, g, slots, d, plan.gen_slots,
        plan.gen_chunks, plan.splits, gen_chunk_beams(beams), float(scale), int(bf16),
        kernel_lib.stream_ptr(q),
    )
    if bf16:
        gen_attention_ancestor.launches_bf16 += 1
    else:
        gen_attention_ancestor.launches += 1
    return out, m, l


gen_attention_ancestor.launches = 0
gen_attention_ancestor.launches_bf16 = 0


_MERGED_OUT_TYPES = (torch.bfloat16, torch.float32)


def ancestry_attention(
    q: torch.Tensor,  # [B*K, h, d]
    prompt_k: torch.Tensor,  # [B, g, Tp, d] int8
    prompt_v: torch.Tensor,
    prompt_mask: torch.Tensor,  # [B, Tp] nonzero = valid
    gen_k: torch.Tensor,  # [B*K, L, g, d] int8
    gen_v: torch.Tensor,
    anc: torch.Tensor,  # [B*K, L] int32
    valid_len: Union[int, torch.Tensor],
    *,
    beams: int,
    scale: float,
    prompt_k_scale: Optional[torch.Tensor] = None,  # [B, g, Tp] f32
    prompt_v_scale: Optional[torch.Tensor] = None,
    gen_k_scale: Optional[torch.Tensor] = None,  # [B*K, L, g] f32
    gen_v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The decode step's attention over both segments: ``merge_softmax_
    segments(prompt_attention(...), gen_attention_ancestor(...))`` cast to
    ``out_dtype`` (default q's type), [B*K, h, d]; exact zeros for a row
    with no valid key in either segment.

    CUDA tensors run the merged entry, one launch on ``decode_plan``'s
    chunks of both segments: bf16 q, int8 K/V with all four f32 scales,
    int32 mask and anc, a bf16 or f32 output."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return ancestry_attention_plain(
            q, prompt_k, prompt_v, prompt_mask, gen_k, gen_v, anc, valid_len, beams=beams,
            scale=scale, prompt_k_scale=prompt_k_scale, prompt_v_scale=prompt_v_scale,
            gen_k_scale=gen_k_scale, gen_v_scale=gen_v_scale, out_dtype=out_dtype,
        )
    if out_dtype not in _MERGED_OUT_TYPES:
        raise ValueError(f"ancestry_attention: output type {out_dtype} (the kernel writes bf16 "
                         "or f32)")
    scales = (prompt_k_scale, prompt_v_scale, gen_k_scale, gen_v_scale)
    if any(s is None for s in scales):
        raise ValueError("ancestry_attention kernel: int8 KV with all four scales")
    _check_gen(q, gen_k, gen_v, anc, gen_k_scale, gen_v_scale, beams, "ancestry_attention")
    rows, h, d = q.shape
    _, slots, g, _ = gen_k.shape
    b, tp = rows // beams, prompt_k.shape[2]
    _check_kv(prompt_k, prompt_v, prompt_k_scale, prompt_v_scale, (b, g, tp, d),
              "ancestry_attention prompt")
    kernel_lib.check(prompt_mask, "prompt_mask", torch.int32, (b, tp))
    plan = decode_plan(b, beams, h, g, d, tp, slots)
    out = torch.empty(rows, h, d, dtype=out_dtype, device=q.device)
    kernel_lib.load().call(
        "mmvc_ancestry_attention", q.data_ptr(), prompt_k.data_ptr(), prompt_v.data_ptr(),
        prompt_k_scale.data_ptr(), prompt_v_scale.data_ptr(), prompt_mask.data_ptr(),
        gen_k.data_ptr(), gen_v.data_ptr(), gen_k_scale.data_ptr(), gen_v_scale.data_ptr(),
        anc.data_ptr(), int(valid_len), out.data_ptr(), b, beams, h, g, tp, slots, d,
        plan.prompt_slots, plan.prompt_chunks, plan.gen_slots, plan.gen_chunks, plan.splits,
        gen_chunk_beams(beams), float(scale), int(out_dtype == torch.float32),
        kernel_lib.stream_ptr(q),
    )
    ancestry_attention.launches += 1
    return out


ancestry_attention.launches = 0
