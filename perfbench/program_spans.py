"""The port's own spans in a traced run, and what they read.

The port opens named spans at its layer boundaries
(``multimodalvc_tpu_torch/runtime/tracing.py``).  ``perfbench/spans.py``
runs a cell's ``--trace 1`` branch with the runner's ``Ranges`` installed as
the port's recorder (``recording``), so every span the program opens becomes
a range with its two marker kernels, resolved by ``Trace`` on the trace's
clock like the benchmark's own ranges.  The port's span names are dotted
(``train.forward``), the benchmark's range names are not (``step``,
``encoder``).  Where no span was recorded, every reading is None.

A span's interval is the launch times of its two markers on the thread that
opened it; an operation belongs to a span when it was launched inside it;
the card's idle gaps are those between ``Trace``'s busy intervals (the union
of device operations, markers excluded), placed on the host's clock by the
launch that ends them.  Times are in microseconds, as the trace gives them.
"""
from __future__ import annotations

import bisect
import json
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

from perfbench.trace import _union

WAIT = ".wait"  # a span around a point where the host blocks on the card


def install(recorder) -> None:
    """Make ``recorder`` the port's span recorder (None: none), where the
    port has the span API."""
    try:
        from multimodalvc_tpu_torch.runtime import tracing
    except ImportError:  # a port without spans: the readers find nothing
        return
    tracing.install(recorder)


def is_program(name: str) -> bool:
    return "." in name


def _per(layer: Optional[Dict], kind: str) -> Optional[int]:
    """The traced steps (training) or batches (synthesis), or None where
    ``layer`` is not of ``kind``."""
    if layer is None or layer.get("kind") != kind:
        return None
    return layer["steps"] if kind == "train" else layer["batches"]


def _main_tid(tr) -> Optional[int]:
    """The thread that opened the steps (the host's main thread)."""
    steps = tr.ranges.get("step", [])
    return steps[0][0] if steps else None


def _windows(tr, name: str) -> List[Tuple[float, float]]:
    """The instances of ``name`` on the main thread, merged and sorted."""
    main = _main_tid(tr)
    return _union([(s, e) for tid, s, e in tr.ranges.get(name, ()) if tid == main])


def launched_ms(layer: Optional[Dict], kind: str, name: str) -> Optional[float]:
    """Device ms a step (or batch) of the operations launched, on any
    thread, while the main thread is inside the span ``name``: with
    ``train.backward`` this takes the kernels autograd's device thread
    launches."""
    n = _per(layer, kind)
    if n is None:
        return None
    tr = layer["trace"]
    win = _windows(tr, name)
    if not win:
        return None
    starts = [s for s, _ in win]
    total = 0.0
    for s, e, _, corr in tr.device:
        hit = tr.launch.get(corr)
        if hit is None:
            continue
        j = bisect.bisect_right(starts, hit[1]) - 1
        if j >= 0 and hit[1] <= win[j][1]:
            total += e - s
    return 1e-3 * total / n


def stacks(tr) -> List[Tuple[float, float, Tuple[str, ...]]]:
    """The main thread's time cut where a program span opens or closes:
    (start, end, the spans open there, outermost first), for each piece
    inside some span."""
    main = _main_tid(tr)
    edges = []
    for name, spans in tr.ranges.items():
        if is_program(name):
            for tid, s, e in spans:
                if tid == main:
                    edges += [(s, 1, name), (e, 0, name)]
    edges.sort(key=lambda x: (x[0], x[1]))  # a span that closes where one opens goes first
    out, open_ = [], []
    for (t, kind, name), nxt in zip(edges, edges[1:] + [None]):
        if kind:
            open_.append(name)
        elif name in open_:
            del open_[len(open_) - 1 - open_[::-1].index(name)]
        if open_ and nxt is not None and nxt[0] > t:
            out.append((t, nxt[0], tuple(open_)))
    return out


def idle_gaps_on_host(tr) -> List[Tuple[float, float]]:
    """The card's idle gaps put on the host's clock: the card waits for the
    operation that ends a gap, which starts as soon as it is launched, so
    the gap is [that launch - the gap's length, that launch].  Only device
    times are subtracted from each other, and only host times compared: the
    two clocks may drift apart by milliseconds within a run."""
    first = {}  # a busy interval's start -> the launch time of an operation starting there
    for s, _, _, corr in tr.device:
        hit = tr.launch.get(corr)
        if hit is not None and (s not in first or hit[1] < first[s]):
            first[s] = hit[1]
    busy = tr._busy
    # merged, so that no idle time counts twice
    return _union([(first[start] - (start - end), first[start])
                   for (_, end), (start, _) in zip(busy, busy[1:])
                   if start > end and start in first])


def idle_by_stack(tr) -> List[Tuple[float, Tuple[str, ...]]]:
    """The card's idle time inside program spans: (us, the spans open on the
    main thread meanwhile), one entry a piece of time; the innermost span is
    the last of the tuple."""
    gaps = idle_gaps_on_host(tr)
    ends = [e for _, e in gaps]
    out = []
    for a, b, stack in stacks(tr):
        idle = 0.0
        j = bisect.bisect_right(ends, a)  # the first gap ending after a
        while j < len(gaps) and gaps[j][0] < b:
            idle += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
        if idle > 0.0:
            out.append((idle, stack))
    return out


def idle_ms(layer: Optional[Dict], kind: str, name: str) -> Optional[float]:
    """Card idle ms a step (or batch) while the main thread is inside the
    span ``name``.  Each idle piece belongs to the innermost span open; a
    wait span nested in ``name`` keeps its own (a synchronisation's idle is
    not the launches')."""
    n = _per(layer, kind)
    if n is None:
        return None
    tr = layer["trace"]
    if not tr.ranges.get(name):
        return None
    total = sum(us for us, stack in idle_by_stack(tr)
                if name in stack and not stack[-1].endswith(WAIT))
    return 1e-3 * total / n


def waits(layer: Optional[Dict], kind: str) -> Optional[float]:
    """Wait spans (host synchronisations) a step (or batch), on any thread;
    None where the trace holds no program span at all."""
    n = _per(layer, kind)
    if n is None:
        return None
    ranges = layer["trace"].ranges
    if not any(is_program(k) for k in ranges):
        return None
    return sum(len(v) for k, v in ranges.items() if k.endswith(WAIT)) / n


# What a traced step (training) or batch (synthesis) reads from the spans
READINGS: Dict[str, Callable[[Optional[Dict]], Optional[float]]] = {
    # device ms launched inside the optimizer (the backward's drain was
    # launched inside ``train.backward``), and the card's idle ms meanwhile
    "optimizer_device_ms.train": lambda layer: launched_ms(layer, "train", "train.optimizer"),
    "optimizer_idle_ms.train": lambda layer: idle_ms(layer, "train", "train.optimizer"),
    "backward_ms.train": lambda layer: launched_ms(layer, "train", "train.backward"),
    "host_syncs.train": lambda layer: waits(layer, "train"),
    "head_ms.synth": lambda layer: launched_ms(layer, "synth", "layer.head"),
    "generator_idle_ms.synth": lambda layer: idle_ms(layer, "synth", "layer.generator"),
    "host_syncs.synth": lambda layer: waits(layer, "synth"),
}


def readings(layer: Dict) -> Dict:
    """The readings of ``READINGS`` that find something, and the card's idle
    ms a step (or batch) by the innermost program span open."""
    n = _per(layer, layer["kind"])
    got = {name: read(layer) for name, read in READINGS.items()}
    idle: Dict[str, float] = {}
    for us, stack in idle_by_stack(layer["trace"]):
        idle[stack[-1]] = idle.get(stack[-1], 0.0) + 1e-3 * us / n
    return {"spans": {k: v for k, v in got.items() if v is not None},
            "idle_ms": dict(sorted(idle.items(), key=lambda kv: -kv[1]))}


@contextmanager
def recording(got: Dict):
    """While open, each ``Ranges`` made is the port's span recorder until its
    ``close``, and the cell's runner's ``Outcome`` is kept in ``got["out"]``."""
    from perfbench import harness, trace

    make, close, runner_of = trace.Ranges.__init__, trace.Ranges.close, harness.runner_of

    def opened(self):
        make(self)
        install(self)

    def closed(self):
        install(None)
        close(self)

    def kept(mix):
        run = runner_of(mix).run

        def run_kept(ctx):
            got["out"] = run(ctx)
            return got["out"]

        return SimpleNamespace(run=run_kept)

    trace.Ranges.__init__, trace.Ranges.close, harness.runner_of = opened, closed, kept
    try:
        yield got
    finally:
        trace.Ranges.__init__, trace.Ranges.close, harness.runner_of = make, close, runner_of
        install(None)


def main(argv: List[str], t0: float) -> int:
    """``harness.main`` with ``--trace 1`` and the port's spans recorded: its
    result line, then one line of ``readings``."""
    from perfbench import harness

    with recording({}) as got:
        rc = harness.main(list(argv) + ["--trace", "1"], t0)
    out = got.get("out")
    if rc == 0 and out is not None and out.layer is not None:
        print(json.dumps(readings(out.layer)), flush=True)
    return rc
