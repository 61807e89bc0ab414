"""What the per-layer metric readers share (``metrics/<name>.py``).

A reader takes the traced run's context (``layer``: the reduced trace, the
traced window's wall seconds, its steps or batches, the attention calls
logged, the model FLOPs of its work) and returns a number, or None where it
finds nothing to read: a roofline share is never given as 0.
"""
from __future__ import annotations

from typing import Dict, Optional

from perfbench import yardstick

PERCENT = 100.0


def _of_kind(layer: Optional[Dict], kind: str) -> bool:
    return layer is not None and layer.get("kind") == kind


def attention_share(layer: Optional[Dict], kind: str, which: str) -> Optional[float]:
    """The least time of the attention calls ``which`` ("fwd" or "bwd")
    received, over the device time of the kernels inside their ranges, in %."""
    if not _of_kind(layer, kind):
        return None
    count = yardstick.flash_fwd if which == "fwd" else yardstick.flash_bwd
    least = 0.0
    for k, (b, h, t, d), lens in layer["attention"]:
        if k == which:
            least += count(b, h, t, d, lens)["bound_s"]
    took = layer["trace"].device_s(f"attn_{which}")
    if least <= 0.0 or took <= 0.0:
        return None
    return PERCENT * least / took


def range_ms(layer: Optional[Dict], kind: str, name: str) -> Optional[float]:
    """Device ms a step (or batch) of the kernels inside the range ``name``."""
    if not _of_kind(layer, kind):
        return None
    took = layer["trace"].device_s(name)
    n = layer["steps"] if kind == "train" else layer["batches"]
    return 1e3 * took / n if took > 0.0 else None


def calls(layer: Optional[Dict], kind: str, name: str) -> Optional[float]:
    """Instances of the range ``name`` a step (or batch)."""
    if not _of_kind(layer, kind):
        return None
    n = layer["steps"] if kind == "train" else layer["batches"]
    got = len(layer["trace"].ranges.get(name, ()))
    return got / n if got else None  # the ranges of the recorded steps alone


def span_ms(layer: Optional[Dict], kind: str, name: str) -> Optional[float]:
    """ms a step from the host's entry into the first instance of ``name`` in
    the step to the end of the last kernel launched inside any instance of
    it in the step."""
    if not _of_kind(layer, kind):
        return None
    tr = layer["trace"]
    steps = sorted(s for _, s, _ in tr.ranges.get("step", ()))
    spans = sorted((s, e, ops) for (_, s, e), ops in
                   zip(tr.ranges.get(name, ()), tr.in_range(name)))
    if not spans or not steps:
        return None
    total = 0.0
    for i, st in enumerate(steps):
        end_of_step = steps[i + 1] if i + 1 < len(steps) else float("inf")
        mine = [(s, ops) for s, _, ops in spans if st <= s < end_of_step]
        if not mine:
            continue
        first = min(s for s, _ in mine)
        last = max([e for _, ops in mine for _, e, _ in ops], default=first)
        total += last - first
    return 1e-3 * total / len(steps) if total > 0.0 else None


def idle_share(layer: Optional[Dict], kind: str) -> Optional[float]:
    """The share of the traced window with no operation on the device, in %."""
    if not _of_kind(layer, kind):
        return None
    return PERCENT * (1.0 - layer["trace"].busy_s() / layer["window_s"])


def mfu(layer: Optional[Dict], kind: str) -> Optional[float]:
    """Model FLOPs of the traced window's work over the window and the bf16
    peak, in %."""
    if not _of_kind(layer, kind) or not layer.get("flops"):
        return None
    return PERCENT * layer["flops"] / layer["window_s"] / yardstick.BF16_FLOPS
