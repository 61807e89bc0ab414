"""Weight-only quantized matmuls: K7 ``int8_matmul`` and K8 ``int4_matmul``.

Port of ``multimodalvc_tpu/ops/int8_matmul.py``.  The serving LLaMA keeps its
projections as int8 with one f32 scale per output column, or as int4 in
group-128 half-split nibbles, and the matmul dequantizes on chip:

- int8: ``y = (bf16(x) @ bf16(w_q)) * scale`` with f32 accumulation, the f32
  scale applied to the f32 sum, then the cast to the output type;
- int4: ``y = bf16(x) @ (bf16(nibble) * bf16(scale))`` with the dequantized
  weight rounded to bf16 and f32 accumulation; no scale after the product.

``x`` becomes bf16 first even when it is f32, as in the JAX package.  The
JAX shape rule sends odd dims and more than 512 rows (prefill, training) to
a dense product: dequantize to bf16, then one matmul with f32 accumulation,
which the JAX package leaves to XLA.  That rule is static; inside it a CUDA
tensor launches its kernel (K7 and K8, one kernel template on one split-K
schedule in ``csrc/int8_matmul.cu``) or raises, and a CPU tensor runs the
plain version, which is the dense product.  ``k7_plan`` and ``k8_plan``
choose the schedule.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import kernel_lib

INT4_GROUP = 128
_QUANT_CHUNK = 4096  # columns per quantization step: bounds the f32 temporaries
_KERNEL_MAX_ROWS = 512
_OUT_TYPES = (torch.bfloat16, torch.float32)


# ---- quantization (the serving formats, byte-identical to the JAX package) ----


# XLA turns the JAX package's ``amax / 127.0`` (a division by a constant) into a
# product with the f32 reciprocal; the scales here do the same, bit for bit.
_RECIP_127 = 1.0 / 127.0
_RECIP_7 = 1.0 / 7.0


def _quantize_int8_chunk(w32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp(w32.abs().amax(dim=0), min=1e-12)
    scale = amax * _RECIP_127
    w_q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127).to(torch.int8)
    return w_q, scale


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[d_in, d_out] float kernel -> (w_q int8 [d_in, d_out], scale f32 [d_out]):
    symmetric per output column over axis 0, ``round`` half to even, amax
    floored at 1e-12.  Column chunks bound the f32 temporaries."""
    d_in, d_out = w.shape
    w_q = torch.empty((d_in, d_out), dtype=torch.int8, device=w.device)
    scale = torch.empty(d_out, dtype=torch.float32, device=w.device)
    for c in range(0, d_out, _QUANT_CHUNK):
        cols = slice(c, c + _QUANT_CHUNK)
        w_q[:, cols], scale[cols] = _quantize_int8_chunk(w[:, cols].float())
    return w_q, scale


def _quantize_int4_chunk(w32: torch.Tensor, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    d_in, d_out = w32.shape
    g = w32.reshape(d_in // group, group, d_out)
    amax = torch.clamp(g.abs().amax(dim=1), min=1e-12)  # [G, d_out]
    scale = amax * _RECIP_7
    q = torch.clamp(torch.round(g / scale[:, None, :]), -7, 7).to(torch.int8).reshape(d_in, d_out)
    half = d_in // 2
    return (q[:half] & 0xF) | (q[half:] << 4), scale


def quantize_kernel_int4(w: torch.Tensor, group: int = INT4_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """[d_in, d_out] float kernel -> (packed int8 [d_in/2, d_out], scales f32
    [d_in/group, d_out]): symmetric int4 per (group, column), clipped to +-7,
    ``packed[r] = (q[r] & 0xF) | (q[r + d_in/2] << 4)``."""
    d_in, d_out = w.shape
    if d_in % (2 * group):
        raise ValueError(f"int4 quantization needs d_in % {2 * group} == 0, got {d_in}")
    packed = torch.empty((d_in // 2, d_out), dtype=torch.int8, device=w.device)
    scale = torch.empty((d_in // group, d_out), dtype=torch.float32, device=w.device)
    for c in range(0, d_out, _QUANT_CHUNK):
        cols = slice(c, c + _QUANT_CHUNK)
        packed[:, cols], scale[:, cols] = _quantize_int4_chunk(w[:, cols].float(), group)
    return packed, scale


def dequantize_int4(w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[d_in/2, d_out] packed + [G, d_out] scales -> bf16 [d_in, d_out]: the
    nibbles sign-extended in int32, each multiplied by its bf16 scale in bf16."""
    half, d_out = w_packed.shape
    n_groups = scale.shape[0]
    w8 = w_packed.to(torch.int32)
    q = torch.cat([((w8 & 0xF) ^ 8) - 8, w8 >> 4], dim=0).to(torch.bfloat16)
    w = q.reshape(n_groups, -1, d_out) * scale[:, None, :].to(torch.bfloat16)
    return w.reshape(2 * half, d_out)


# ---- the plain versions (also the dense product of the shape rule) ------------


def _bf16_matmul_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 [rows, d_in] @ bf16 [d_in, d_out] with f32 accumulation -> f32.
    Products of bf16 values are exact in f32, so the CPU's f32 matmul of the
    widened operands is the same product."""
    if x2.is_cuda:
        return torch.mm(x2, w, out_dtype=torch.float32)
    return x2.float() @ w.float()


def int8_matmul_plain(x, w_q, scale, out_dtype=None) -> torch.Tensor:
    """Plain version of K7: dequantize to bf16 (exact), one matmul."""
    d_in, d_out = w_q.shape
    x2 = x.reshape(-1, d_in).to(torch.bfloat16)
    y = _bf16_matmul_f32(x2, w_q.to(torch.bfloat16)) * scale.reshape(1, d_out).float()
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], d_out)


def int4_matmul_plain(x, w_packed, scale, out_dtype=None) -> torch.Tensor:
    """Plain version of K8: dequantize to bf16, one matmul."""
    half, d_out = w_packed.shape
    x2 = x.reshape(-1, 2 * half).to(torch.bfloat16)
    y = _bf16_matmul_f32(x2, dequantize_int4(w_packed, scale))
    return y.to(out_dtype or x.dtype).reshape(*x.shape[:-1], d_out)


# ---- the kernel wrappers -----------------------------------------------------


# K7's and K8's schedule (csrc/int8_matmul.cu): a block owns 128 output
# columns, a row tile of at most 64 rows and a K chunk of KC weight rows (K8:
# packed rows, each two logical rows), streamed 32 rows a stage; split-K until
# the grid holds K7_MIN_BLOCKS blocks, keeping KC >= 128.  On the H100 more
# splits (two blocks an SM, 264) cost more in the split sum than they gain in
# bytes in flight.  Above K7_ONE_LEVEL splits the sum takes two levels.
K7_BN, K7_KSTEP, K7_MIN_KC, K7_MAX_ROW_TILE = 128, 32, 128, 64
K7_MIN_BLOCKS, K7_ONE_LEVEL = 128, 8
K7_COUNTERS = 4096  # int32 arrival counters a device and kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class SplitPlan(NamedTuple):
    splits: int  # K chunks, one block each
    kc: int  # weight rows (K8: packed rows) a block reads: k_rows // splits
    group: int  # splits summed together first (the two-level split-K sum)
    row_tile: int  # rows a block computes, a multiple of 8
    workspace: int  # f32 partials [splits, rows, d_out], 0 with one split
    counters: int  # arrival counters: per tile, one a group and one for the groups


def _split_plan(rows: int, k_rows: int, d_out: int, step: int) -> SplitPlan:
    """The fewest splits that give the grid K7_MIN_BLOCKS blocks, among
    those whose KC divides k_rows, is a multiple of ``step`` and is at least
    K7_MIN_KC; the most such splits where none reaches it; 1 where the
    column and row tiles alone fill the card."""
    row_tiles = _cdiv(rows, K7_MAX_ROW_TILE)
    row_tile = 8 * _cdiv(_cdiv(rows, row_tiles), 8)
    tiles = d_out // K7_BN * row_tiles
    splits = 1
    if tiles < K7_MIN_BLOCKS:
        for s in range(2, k_rows // K7_MIN_KC + 1):
            if k_rows % (s * step) == 0:
                splits = s
                if tiles * s >= K7_MIN_BLOCKS:
                    break
    # ceil(sqrt(splits)) a group: each level's summing block reads ~sqrt(splits)
    group = splits if splits <= K7_ONE_LEVEL else math.isqrt(splits - 1) + 1
    groups = _cdiv(splits, group)
    workspace = counters = 0
    if splits > 1:
        workspace = splits * rows * d_out
        counters = tiles * (groups + 1 if groups > 1 else 1)
    return SplitPlan(splits, k_rows // splits, group, row_tile, workspace, counters)


@functools.lru_cache(maxsize=None)  # a decode step asks for the same few shapes 197 times
def k7_plan(rows: int, d_in: int, d_out: int) -> SplitPlan:
    """K7's plan over the d_in weight rows, in K chunks of whole 32-row
    stages."""
    return _split_plan(rows, d_in, d_out, K7_KSTEP)


@functools.lru_cache(maxsize=None)
def k8_plan(rows: int, d_in: int, d_out: int, group: int = INT4_GROUP) -> SplitPlan:
    """K8's plan over the d_in / 2 packed rows, in K chunks of whole scale
    groups of each half.  A stage lies in one group of each half only when
    ``group`` is a multiple of the 32-row stage: K8 takes no other."""
    if group % K7_KSTEP:
        raise ValueError(f"int4_matmul: scale group {group} is not a multiple of {K7_KSTEP}")
    return _split_plan(rows, d_in // 2, d_out, group)


# per device and kernel: K7_COUNTERS zeroed int32 arrival counters (a split
# plan has fewer tiles than K7_MIN_BLOCKS, each with at most groups + 1
# counters); the kernel sets each back to 0 once every block it counts has
# arrived.  K7 and K8 never share one.
_COUNTERS = {}


def _split_buffers(plan: SplitPlan, device: torch.device, kernel: str) -> tuple:
    """(workspace, its pointer, the counters' pointer) for the C entry: null
    pointers with one split.  The caller keeps the workspace referenced
    until the launch is queued."""
    if plan.splits == 1:
        return None, None, None
    if plan.counters > K7_COUNTERS:
        raise ValueError(f"{kernel}: {plan.counters} arrival counters > {K7_COUNTERS}")
    counters = _COUNTERS.get((device, kernel))
    if counters is None:
        counters = torch.zeros(K7_COUNTERS, dtype=torch.int32, device=device)
        _COUNTERS[(device, kernel)] = counters
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=device)
    return ws, ws.data_ptr(), counters.data_ptr()


def _operands(x, d_in: int, d_out: int, out_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"output type {out_dtype} (the kernels write bf16 or f32)")
    x2 = x.reshape(-1, d_in).to(torch.bfloat16).contiguous()
    kernel_lib.check(x2, "x", torch.bfloat16)
    return x2, torch.empty((x2.shape[0], d_out), dtype=out_dtype, device=x.device)


def int8_matmul(
    x: torch.Tensor,  # [..., d_in]
    w_q: torch.Tensor,  # [d_in, d_out] int8
    scale: torch.Tensor,  # [d_out] f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``(bf16(x) @ w_q) * scale`` in ``out_dtype`` (default x's type).

    Inside the JAX shape rule (d_in % 128 == 0, d_out % 128 == 0, rows <= 512)
    a CUDA tensor runs K7 on ``k7_plan``'s schedule; outside it the dense
    product runs."""
    d_in, d_out = w_q.shape
    rows = x.numel() // d_in
    out_dtype = out_dtype or x.dtype
    if d_in % 128 or d_out % 128 or rows > _KERNEL_MAX_ROWS or x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale, out_dtype)
    kernel_lib.check(w_q, "w_q", torch.int8, (d_in, d_out))
    kernel_lib.check(scale, "scale", torch.float32, (d_out,))
    x2, out = _operands(x, d_in, d_out, out_dtype)
    plan = k7_plan(rows, d_in, d_out)
    ws, ws_ptr, counters_ptr = _split_buffers(plan, x.device, "int8_matmul")
    kernel_lib.load().call(
        "mmvc_int8_matmul", x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws_ptr, counters_ptr, rows, d_in, d_out, plan.splits, plan.kc, plan.group, plan.row_tile,
        int(out_dtype == torch.float32), kernel_lib.stream_ptr(x2),
    )
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], d_out)


int8_matmul.launches = 0


def int4_matmul(
    x: torch.Tensor,  # [..., d_in]
    w_packed: torch.Tensor,  # [d_in/2, d_out] int8, half-split nibbles
    scale: torch.Tensor,  # [d_in/group, d_out] f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``bf16(x) @ dequant(w_packed, scale)`` in ``out_dtype``.

    Inside the JAX shape rule (d_in/2 % 128 == 0 and % group, d_out % 128 == 0,
    rows <= 512) a CUDA tensor runs K8 on ``k8_plan``'s schedule, which
    raises for a group that is not a multiple of 32; outside it the dense
    product runs."""
    half, d_out = w_packed.shape
    d_in = 2 * half
    group = d_in // scale.shape[0]
    rows = x.numel() // d_in
    out_dtype = out_dtype or x.dtype
    if (half % 128 or d_out % 128 or half % group or rows > _KERNEL_MAX_ROWS
            or x.device.type == "cpu"):
        return int4_matmul_plain(x, w_packed, scale, out_dtype)
    kernel_lib.check(w_packed, "w_packed", torch.int8, (half, d_out))
    kernel_lib.check(scale, "scale", torch.float32, (d_in // group, d_out))
    x2, out = _operands(x, d_in, d_out, out_dtype)
    plan = k8_plan(rows, d_in, d_out, group)
    ws, ws_ptr, counters_ptr = _split_buffers(plan, x.device, "int4_matmul")
    kernel_lib.load().call(
        "mmvc_int4_matmul", x2.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
        out.data_ptr(), ws_ptr, counters_ptr, rows, d_in, d_out, plan.splits, plan.kc,
        plan.group, plan.row_tile, group, int(out_dtype == torch.float32),
        kernel_lib.stream_ptr(x2),
    )
    int4_matmul.launches += 1
    return out.reshape(*x.shape[:-1], d_out)


int4_matmul.launches = 0
