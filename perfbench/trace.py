"""Ranges around the port's layers, and the reduction of a device trace.

``Ranges`` installs run-time wrappers from the benchmark's side (no program
file is edited) that log a named range on the host: around a module's
``forward`` or a bound method, around the K1 entry ``flash_attention`` (as
the encoders and the head call it) and ``FlashAttentionGrad.backward``
(each call's shape and key lengths logged too), and around each step.  A
range opens and closes with a marker kernel (``torch.cuda._sleep`` of a few
cycles), so that no clock has to agree with the profiler's.

The profiler records the device alone (``ProfilerActivity.CUDA``): the
kernels, copies and fills, and the CUDA API calls that launched them, with
their thread and time.  It records no host operator, so it slows the host
by little: a kernel belongs to a range when its launch lies between the
range's two markers' launches on their thread.
"""
from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK_CYCLES = 64
MARK_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def _now_us() -> float:
    return time.monotonic_ns() / 1e3


class Ranges:
    """Wrappers that log a named range around calls into a layer; undone by
    ``close``."""

    def __init__(self):
        self._undo: List = []
        self.log: List[Tuple[str, int, int]] = []  # (name, opening mark, closing mark)
        self.marks: List[float] = []
        self.attn: List[Tuple[str, tuple, object]] = []  # (kind, (b, h, t, d), kv_lens)

    @contextmanager
    def span(self, name: str):
        """The range ``name`` around the block: a marker kernel launched as it
        opens and another as it closes."""
        first = self.mark()
        try:
            yield
        finally:
            self.log.append((name, first, self.mark()))

    def mark(self) -> int:
        """Launch a marker kernel (a spin of a few cycles), log the host time
        of its launch, and return its index."""
        import torch

        self.marks.append(_now_us())
        torch.cuda._sleep(MARK_CYCLES)
        return len(self.marks) - 1

    def reset(self) -> None:
        """Forget the ranges, marks and calls logged so far."""
        self.log.clear()
        self.attn.clear()
        self.marks.clear()

    def method(self, obj, attr: str, name: str) -> None:
        """``obj.attr(...)`` inside the range ``name`` (an instance attribute
        over the class's method)."""
        inner = getattr(obj, attr)
        span = self.span

        def wrapped(*a, **k):
            with span(name):
                return inner(*a, **k)

        had = attr in vars(obj)
        setattr(obj, attr, wrapped)
        self._undo.append(lambda: setattr(obj, attr, inner) if had else delattr(obj, attr))

    def attention(self) -> None:
        """The K1 entry as ``nn/layers.py`` and ``nn/whisper.py`` call it
        (range "attn_fwd"), and the backward of ``FlashAttentionGrad`` (range
        "attn_bwd"), each call's shape and key lengths logged."""
        from multimodalvc_tpu_torch.nn import layers, whisper
        from multimodalvc_tpu_torch.ops import attention

        entry, log, span = attention.flash_attention, self.attn, self.span

        def fwd(q, k, v, kv_lens=None, *a, **kw):
            log.append(("fwd", tuple(q.shape), kv_lens))
            with span("attn_fwd"):
                return entry(q, k, v, kv_lens, *a, **kw)

        for mod in (layers, whisper):
            self._patch(mod, "flash_attention", fwd)
        backward = attention.FlashAttentionGrad.backward

        def bwd(ctx, g):
            q, _, _, kv_lens, _ = ctx.saved_tensors
            log.append(("bwd", tuple(q.shape), kv_lens))
            with span("attn_bwd"):
                return backward(ctx, g)

        self._patch(attention.FlashAttentionGrad, "backward", staticmethod(bwd))

    def _patch(self, owner, attr, value) -> None:
        old = owner.__dict__[attr]
        setattr(owner, attr, value)
        self._undo.append(lambda: setattr(owner, attr, old))

    def attention_calls(self) -> List[Tuple[str, tuple, List[int]]]:
        """The logged calls with their key lengths on the host (None: every
        key)."""
        out = []
        for kind, shape, lens in self.attn:
            b, _, t, _ = shape
            out.append((kind, shape, [t] * b if lens is None else [int(x) for x in lens.tolist()]))
        return out

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


def profile(active_steps: int):
    """A ``torch.profiler`` of the device: one warm-up step (the profiler's
    own start-up), then ``active_steps`` recorded steps."""
    from torch.profiler import ProfilerActivity, profile as _profile, schedule

    return _profile(activities=[ProfilerActivity.CUDA],
                    schedule=schedule(wait=0, warmup=1, active=active_steps, repeat=1),
                    acc_events=False)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


MAX_LOST = 4  # markers the profiler may miss where its recording starts or stops


def _aligned(order: List[int], marks: List[float], found: List[Tuple[float, int]]) -> List[int]:
    """The host marks (indices, in time order) that the found markers'
    launches are: all of them, or, where the trace lacks a few at its edges,
    the run of them whose offsets to the trace's clock agree best."""
    lost = len(order) - len(found)
    if not found or not 0 <= lost <= MAX_LOST:
        return []

    def disagreement(shift: int) -> float:
        d = [ts - marks[i] for i, (ts, _) in zip(order[shift:], found)]
        return max(d) - min(d)

    best = min(range(lost + 1), key=disagreement)
    return order[best:best + len(found)]


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name, its leading "void " dropped, cut at ``limit``."""
    return name[5:limit + 5] if name.startswith("void ") else name[:limit]


class Trace:
    """One exported chrome trace of the device, with the host's ranges.
    Times in microseconds as the trace gives them; the public figures in
    seconds."""

    def __init__(self, path: str, ranges: List[Tuple[str, int, int]], marks: List[float]):
        """``ranges``: (name, its opening mark, its closing mark), indices into
        ``marks``, the host's times of the markers' launches.  A range whose
        markers the trace lacks is dropped."""
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device: List[Tuple[float, float, str, Optional[int]]] = []
        self.launch: Dict[int, Tuple[int, float]] = {}
        self.cats: Dict[str, int] = defaultdict(int)
        for e in events:
            cat = e.get("cat")
            self.cats[str(cat)] += 1
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                self.device.append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"],
                                    e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = (e["tid"], e["ts"])
        # the markers' launches, in time order, are the host's marks in time
        # order: each range becomes the span between its two markers'
        # launches on the thread that launched them
        found = sorted((ts, tid) for _, _, n, c in self.device if MARK_KERNEL in n
                       and c in self.launch for tid, ts in [self.launch[c]])
        order = sorted(range(len(marks)), key=marks.__getitem__)
        self.marks_found = len(found)
        at = {i: f for i, f in zip(_aligned(order, marks, found), found)}
        self.ranges: Dict[str, List[Tuple[int, float, float]]] = defaultdict(list)
        for name, first, last in ranges:
            if first in at and last in at:
                self.ranges[name].append((at[first][1], at[first][0], at[last][0]))
        # the markers are the benchmark's, not the program's work
        self.device = sorted(d for d in self.device if MARK_KERNEL not in d[2])
        self._busy = _union([(s, e) for s, e, _, _ in self.device])
        self.busy_us = sum(e - s for s, e in self._busy)

    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    def in_range(self, name: str) -> List[List[Tuple[float, float, str]]]:
        """For each instance of the range ``name``: the device operations
        launched inside it (on its thread, between its start and end)."""
        spans = self.ranges.get(name, [])
        by_tid: Dict[int, List] = defaultdict(list)
        for i, (tid, s, e) in enumerate(spans):
            by_tid[tid].append((s, e, i))
        starts = {}
        for tid, lst in by_tid.items():
            lst.sort()
            starts[tid] = [s for s, _, _ in lst]
        out: List[List[Tuple[float, float, str]]] = [[] for _ in spans]
        for s, e, kname, corr in self.device:
            hit = self.launch.get(corr)
            if hit is None or hit[0] not in by_tid:
                continue
            tid, ts = hit
            j = bisect.bisect_right(starts[tid], ts) - 1
            if j >= 0:
                rs, re_, i = by_tid[tid][j]
                if ts <= re_:
                    out[i].append((s, e, kname))
        return out

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside every instance of
        the range ``name``."""
        return 1e-6 * sum(e - s for ops in self.in_range(name) for s, e, _ in ops)

    def attributed(self, name: str = "step") -> float:
        """The share of device operations launched inside some ``name``
        range: near 1 where the host's and the profiler's clocks agree."""
        n = sum(len(ops) for ops in self.in_range(name))
        return n / max(len(self.device), 1)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for s, e, name, _ in self.device:
            total[short_name(name)] += e - s
        return [[k, v * 1e-6] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest gaps between device operations, each named by the
        innermost range open on the host where the gap starts (the main
        thread: the one that opened the steps)."""
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(self._busy, self._busy[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        steps = self.ranges.get("step", [])
        main = steps[0][0] if steps else None
        out = []
        for length, at in gaps[:n]:
            rng = [(e - s, name) for name, spans in self.ranges.items()
                   for tid, s, e in spans if tid == main and s <= at <= e]
            out.append([min(rng)[1] if rng else "outside", length * 1e-6])
        return out

    def summary(self) -> Dict:
        return {"events": dict(self.cats), "device_ops": len(self.device),
                "launches": len(self.launch), "marks": self.marks_found,
                "ranges": sum(len(v) for v in self.ranges.values()),
                "in_steps": self.attributed("step")}
