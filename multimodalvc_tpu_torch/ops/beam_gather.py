"""Beam-reorder row gather: K6 ``gather_rows``.

Port of ``multimodalvc_tpu/ops/beam_gather.py``: ``out[i] = x[src[i]]``
along dim 0, trailing dims copied whole.  The physical beam reorder of the
large generated-KV leaves takes it (``ops/beam_search.py: _gather_beams``).
For CUDA tensors ``gather_rows`` launches ``csrc/beam_gather.cu``; for CPU
tensors it runs the plain version, ``torch.index_select``.
"""
from __future__ import annotations

import torch

from . import kernel_lib


def gather_rows_plain(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version of K6."""
    return torch.index_select(x, 0, src.long())


def gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[i] = x[src[i]] over the leading axis; x [N, ...] (>= 2-D), src [M]
    int32.  CUDA tensors run K6: x contiguous with rows of a multiple of 16
    bytes."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, src)
    n, m = x.shape[0], src.shape[0]
    kernel_lib.check(x, "x", x.dtype)
    kernel_lib.check(src, "src", torch.int32, (m,))
    row_bytes = x[0].numel() * x.element_size()
    if x.ndim < 2 or row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"gather_rows kernel: rows of {row_bytes} bytes (needs 16-byte rows)")
    out = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    kernel_lib.load().call(
        "mmvc_gather_rows", x.data_ptr(), src.data_ptr(), out.data_ptr(), n, m, row_bytes,
        kernel_lib.stream_ptr(x),
    )
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_beams_rows(x: torch.Tensor, indices: torch.Tensor, b: int, k: int) -> torch.Tensor:
    """Beam-select rows of a flattened [B*K, ...] leaf: indices [B, K] pick
    the parent beam within each batch row."""
    offsets = torch.arange(b, dtype=indices.dtype, device=indices.device)[:, None] * k
    return gather_rows(x, (indices + offsets).reshape(-1).to(torch.int32))
