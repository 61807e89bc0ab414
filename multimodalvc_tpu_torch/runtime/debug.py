"""Failure detection for the training loop.

Port of what ``cli/train.py`` calls from ``multimodalvc_tpu/runtime/debug.py``:

- ``find_nonfinite``: the names of a module's (or a dict's) tensors holding
  NaN or Inf, to localise a non-finite loss;
- ``Watchdog``: a context manager around blocking work that logs when the
  body outlasts ``common.step_timeout_s``;
- ``with_oom_batch_split``: run a step on a batch and, on
  ``torch.cuda.OutOfMemoryError``, again on its two halves.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Union

import torch

logger = logging.getLogger(__name__)


def find_nonfinite(tensors: Union[torch.nn.Module, Dict[str, torch.Tensor]],
                   prefix: str = "") -> List[str]:
    """"name (n/size non-finite)" for each floating tensor with a NaN or an
    Inf: the parameters and buffers of a module, or a dict's tensors."""
    if isinstance(tensors, torch.nn.Module):
        tensors = dict(tensors.state_dict())
    bad: List[str] = []
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor) or not x.is_floating_point():
            continue
        n_bad = int((~torch.isfinite(x)).sum())
        if n_bad:
            bad.append(f"{prefix}{name} ({n_bad}/{x.numel()} non-finite)")
    return bad


class Watchdog:
    """Log when the body does not finish within ``timeout_s`` (``on_timeout``
    fires from a daemon thread; ``fired`` records it)."""

    def __init__(self, timeout_s: float, on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or self._default_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _default_timeout(self):
        self.fired = True
        logger.error("watchdog: step exceeded %.1f s (a device hang?)", self.timeout_s)

    def __enter__(self):
        self.fired = False
        self._timer = threading.Timer(self.timeout_s, self.on_timeout)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        if self._timer is not None:
            self._timer.cancel()
        return False


def _batch_rows(batch) -> int:
    """The batch size: the largest dim 0."""
    sizes = [int(v.shape[0]) for v in batch.values() if hasattr(v, "ndim") and v.ndim >= 1]
    return max(sizes) if sizes else 0


def _rows(batch, index: slice, rows: int):
    """Each array whose dim 0 is ``rows``, sliced along dim 0."""
    return {k: v[index] if hasattr(v, "ndim") and v.ndim >= 1 and v.shape[0] == rows else v
            for k, v in batch.items()}


def is_oom_error(e: BaseException) -> bool:
    return isinstance(e, torch.cuda.OutOfMemoryError) or "out of memory" in str(e)


def with_oom_batch_split(fn, batch, max_splits: int = 3) -> list:
    """``[fn(batch)]``; on a device OOM, the halves' results, each half
    retried the same way (``max_splits`` deep).  Other errors, and an OOM on
    a batch that cannot be split, propagate."""
    try:
        return [fn(batch)]
    except Exception as e:
        if not is_oom_error(e):
            raise
        rows = _batch_rows(batch)
        if rows <= 1 or max_splits <= 0:
            raise
        logger.warning("device OOM on a %d-row batch: retrying as two halves (%d splits left)",
                       rows, max_splits - 1)
        torch.cuda.empty_cache()
        half = rows // 2
        return (with_oom_batch_split(fn, _rows(batch, slice(0, half), rows), max_splits - 1)
                + with_oom_batch_split(fn, _rows(batch, slice(half, rows), rows), max_splits - 1))
