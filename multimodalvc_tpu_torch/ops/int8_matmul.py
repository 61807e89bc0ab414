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
tensor launches ``csrc/quant_matmul.cu`` or raises, and a CPU tensor runs the
plain version, which is the dense product.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _launch(name: str, x, w, scale, out_dtype, d_in: int, d_out: int, *extra) -> torch.Tensor:
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"{name}: output type {out_dtype} (kernel writes bf16 or f32)")
    x2 = x.reshape(-1, d_in).to(torch.bfloat16).contiguous()
    rows = x2.shape[0]
    kernel_lib.check(x2, "x", torch.bfloat16)
    out = torch.empty((rows, d_out), dtype=out_dtype, device=x.device)
    kernel_lib.load().call(
        name, x2.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d_in,
        d_out, *extra, int(out_dtype == torch.float32), kernel_lib.stream_ptr(x2),
    )
    return out.reshape(*x.shape[:-1], d_out)


def int8_matmul(
    x: torch.Tensor,  # [..., d_in]
    w_q: torch.Tensor,  # [d_in, d_out] int8
    scale: torch.Tensor,  # [d_out] f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``(bf16(x) @ w_q) * scale`` in ``out_dtype`` (default x's type).

    Inside the JAX shape rule (d_in % 128 == 0, d_out % 128 == 0, rows <= 512)
    a CUDA tensor runs K7; outside it the dense product runs."""
    d_in, d_out = w_q.shape
    rows = x.numel() // d_in
    out_dtype = out_dtype or x.dtype
    if d_in % 128 or d_out % 128 or rows > _KERNEL_MAX_ROWS or x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale, out_dtype)
    kernel_lib.check(w_q, "w_q", torch.int8, (d_in, d_out))
    kernel_lib.check(scale, "scale", torch.float32, (d_out,))
    y = _launch("mmvc_int8_matmul", x, w_q, scale, out_dtype, d_in, d_out)
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


def int4_matmul(
    x: torch.Tensor,  # [..., d_in]
    w_packed: torch.Tensor,  # [d_in/2, d_out] int8, half-split nibbles
    scale: torch.Tensor,  # [d_in/group, d_out] f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``bf16(x) @ dequant(w_packed, scale)`` in ``out_dtype``.

    Inside the JAX shape rule (d_in/2 % 128 == 0 and % group, d_out % 128 == 0,
    rows <= 512) a CUDA tensor runs K8; outside it the dense product runs."""
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
    y = _launch("mmvc_int4_matmul", x, w_packed, scale, out_dtype, d_in, d_out, group)
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0
