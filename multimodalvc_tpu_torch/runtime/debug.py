"""Failure detection for the training loop.

Port of what ``cli/train.py`` calls from ``multimodalvc_tpu/runtime/debug.py``:

- ``find_nonfinite``: the names of a module's (or a dict's) tensors holding
  NaN or Inf, to localise a non-finite loss;
- ``NanDetector``: re-runs a loss with its gradient and lists the
  non-finite gradient and parameter leaves (``cli.train`` calls it on the
  batch of a non-finite logged loss);
- ``checkify_loss``: a loss that raises at the first module whose output is
  non-finite (forward hooks; the counterpart of checkify's float checks);
- ``check_cross_process_scalar``: a host scalar (the grad norm) held equal
  across the processes of the default group;
- ``Watchdog``: a context manager around blocking work that logs when the
  body outlasts ``common.step_timeout_s``;
- ``with_oom_batch_split``: run a step on a batch and, on
  ``torch.cuda.OutOfMemoryError``, again on its two halves.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

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


class NanDetector:
    """Re-run a failed batch and list its non-finite gradients and
    parameters (the JAX ``NanDetector``; reference: fairseq's nan_detector,
    invoked from trainer.py:835-850).

    ``loss_fn(*args) -> (loss, aux)``.  With ``params`` (a dict of the
    tensors the loss reaches, such as ``Trainer.params``) ``run(*args)``
    differentiates with respect to them; without, ``run(params, *args)``
    takes the JAX call's form: the first argument is a dict of tensors, which
    the loss receives as leaves that take a gradient."""

    def __init__(self, loss_fn: Callable, params: Optional[Dict[str, torch.Tensor]] = None):
        self.loss_fn, self.params = loss_fn, params

    def run(self, *args) -> Dict[str, Any]:
        params = self.params
        if params is None:
            params = {n: t.detach().clone().requires_grad_(t.is_floating_point())
                      for n, t in args[0].items()}
            args = (params,) + tuple(args[1:])
        with torch.enable_grad():
            loss, _ = self.loss_fn(*args)
            names = [n for n, t in params.items() if t.requires_grad]
            got = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
        report: Dict[str, Any] = {"loss_nonfinite": not bool(torch.isfinite(loss.detach()).all())}
        grads = {n: g for n, g in zip(names, got) if g is not None}
        report["nonfinite_grads"] = find_nonfinite(grads, "grads/")
        report["nonfinite_params"] = find_nonfinite(
            {n: t.detach() for n, t in params.items()}, "params/")
        for line in report["nonfinite_grads"] + report["nonfinite_params"]:
            logger.error("NanDetector: %s", line)
        return report


def _nonfinite(out) -> bool:
    """Whether a module's output (a tensor, or tensors in dicts, lists and
    tuples) holds a NaN or an Inf."""
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and not bool(torch.isfinite(out).all())
    if isinstance(out, dict):
        return any(_nonfinite(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_nonfinite(v) for v in out)
    return False


def checkify_loss(loss_fn: Callable, module: Optional[torch.nn.Module] = None):
    """``loss_fn`` wrapped so that a NaN or an Inf raises
    ``FloatingPointError``: at the first submodule of ``module`` whose output
    holds one (forward hooks, for the call only), else at the loss's output.
    The counterpart of the JAX ``checkify_loss`` (checkify's float checks,
    the compiled form of fairseq's module hooks)."""

    def check(name):
        def hook(_mod, _inputs, out):
            if _nonfinite(out):
                raise FloatingPointError(f"non-finite output of module {name or '<root>'}")
        return hook

    def wrapped(*args, **kwargs):
        handles = [] if module is None else [
            m.register_forward_hook(check(name)) for name, m in module.named_modules()]
        try:
            out = loss_fn(*args, **kwargs)
        finally:
            for h in handles:
                h.remove()
        if _nonfinite(out):
            raise FloatingPointError("non-finite loss output")
        return out

    return wrapped


def check_cross_process_scalar(name: str, value: float, atol: float = 1e-4) -> bool:
    """Whether a host scalar (the grad norm) agrees across the processes of
    the default group, within ``atol`` * (1 + |rank 0's|) (the JAX check;
    reference: trainer.py:1300-1337).  True without a group or with one
    process; every process of a group must call it."""
    if not dist.is_available() or not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([float(value)], dtype=torch.float32, device=device)
    gathered = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    values = torch.cat(gathered).cpu()
    ok = bool(((values - values[0]).abs() <= atol * (1 + values[0].abs())).all())
    if not ok:
        logger.error("cross-process %s divergence: %s (different data or a non-deterministic "
                     "op order)", name, values.tolist())
    return ok


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
