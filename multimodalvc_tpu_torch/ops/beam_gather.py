"""Beam-reorder row gather: K6 ``gather_rows``.

Port of ``multimodalvc_tpu/ops/beam_gather.py``: ``out[i] = x[src[i]]``
along dim 0, trailing dims copied whole.  The physical beam reorder of the
large generated-KV leaves takes it (``ops/beam_search.py: _gather_beams``),
every leaf of a step in one call of ``gather_rows_many``, since all of them
move by the same beam indices.  For CUDA tensors both entries launch
``csrc/beam_gather.cu`` (a single leaf is a table of one); for CPU tensors
they run the plain versions, ``torch.index_select``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import kernel_lib

GATHER_MAX_LEAVES = 64  # csrc/beam_gather.cu: MAX_LEAVES, leaves a launch


def gather_rows_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version of K6."""
    return torch.index_select(x, 0, src.long())


def gather_rows_many_plain(xs: Sequence[torch.Tensor], src: torch.Tensor) -> List[torch.Tensor]:
    """Plain version of the many-leaf entry: ``index_select`` a leaf."""
    return [gather_rows_plain(x, src) for x in xs]


def _check_leaf(x: torch.Tensor) -> int:
    """Validate one leaf for the kernel; its row bytes."""
    kernel_lib.check(x, "x", x.dtype)
    row_bytes = x[0].numel() * x.element_size() if x.ndim >= 2 and x.shape[0] else 0
    if x.ndim < 2 or row_bytes == 0 or row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"gather_rows kernel: rows of {row_bytes} bytes (needs 16-byte rows)")
    return row_bytes


def gather_rows_many(xs: Sequence[torch.Tensor], src: torch.Tensor) -> List[torch.Tensor]:
    """[out_l[i] = x_l[src[i]] for every leaf x_l [N_l, ...] (>= 2-D)], src
    [M] int32 shared by all of them.  CUDA tensors run K6 once for every
    ``GATHER_MAX_LEAVES`` leaves (a decode step's 56 in one launch): each
    contiguous with rows of a multiple of 16 bytes."""
    xs = list(xs)
    if all(x.device.type == "cpu" for x in xs) and src.device.type == "cpu":
        return gather_rows_many_plain(xs, src)
    m = src.shape[0]
    row_bytes = [_check_leaf(x) for x in xs]
    kernel_lib.check(src, "src", torch.int32, (m,))
    outs = [torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device) for x in xs]
    for i in range(0, len(xs), GATHER_MAX_LEAVES):
        part = slice(i, i + GATHER_MAX_LEAVES)
        ins, out, rb = xs[part], outs[part], row_bytes[part]
        count = len(ins)
        kernel_lib.load().call(
            "mmvc_gather_rows_many", count,
            (ctypes.c_void_p * count)(*[x.data_ptr() for x in ins]),
            (ctypes.c_void_p * count)(*[o.data_ptr() for o in out]),
            (ctypes.c_longlong * count)(*rb), (ctypes.c_int * count)(*[x.shape[0] for x in ins]),
            src.data_ptr(), m, kernel_lib.stream_ptr(ins[0]),
        )
        gather_rows.launches += 1
    return outs


def gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[i] = x[src[i]] over the leading axis; x [N, ...] (>= 2-D), src [M]
    int32.  CUDA tensors run K6 with a table of one leaf: x contiguous with
    rows of a multiple of 16 bytes."""
    return gather_rows_many([x], src)[0]


gather_rows.launches = 0  # one a launch: a leaf, or every leaf of a gather_rows_many


def beam_src(indices: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """The flat source rows [B*K] int32 of a beam reorder: indices [B, K]
    pick the parent beam within each batch row."""
    offsets = torch.arange(b, dtype=indices.dtype, device=indices.device)[:, None] * k
    return (indices + offsets).reshape(-1).to(torch.int32)


def gather_beams_rows(x: torch.Tensor, indices: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """Beam-select rows of a flattened [B*K, ...] leaf: indices [B, K] pick
    the parent beam within each batch row."""
    return gather_rows(x, beam_src(indices, b, k))
