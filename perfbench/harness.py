"""One run of one cell: the contract's command line, set-up, the measured
window, the check of the outputs, the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: ``BENCHMARK.json`` names the cell's configuration
file and mix; the mix names its runner (``runners/<runner>.py``); each
per-layer metric is read by ``metrics/<name>.py``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# JAX, its libraries and the JAX package, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "multimodalvc_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, an unknown cell...)."""


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def set_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX; one
    host thread for CPU operators, so that the run is one process with few
    threads (the program's host work is Python's dispatch and launches)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: Dict, root: Path, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise BenchError(f"no configuration {name!r} in BENCHMARK.json")


def mix_of(root: Path, name: str) -> Dict:
    return load_json(root / "perfbench" / "traffic" / f"{name}.json")


def runner_of(mix: Dict):
    return importlib.import_module(f"perfbench.runners.{mix['runner']}")


def limits_of(root: Path, cell: str) -> Dict[str, float]:
    return load_json(root / "perfbench" / "limits" / f"{cell}.json")


def reader(root: Path, metric: str) -> Callable:
    """``metrics/<metric>.py``'s ``read``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those whose
    ``workloads`` list it, and those without the key wherever the metric
    they move (an end-to-end metric: the cell) is reported."""
    e2e = {m["name"]: m for m in cell_end_to_end(bench, cell)}
    if kind == "end_to_end":
        return list(e2e.values())
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def cell_end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Context:
    """What a runner is given."""

    cell: Dict
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    root: Path = ROOT
    t0: float = field(default_factory=time.perf_counter)
    limits: Dict[str, float] = field(default_factory=dict)
    fault: Optional[str] = None  # a test's break of the timed path (runners' ``Program``)
    log: Callable = field(default=lambda *a: print(*a, file=sys.stderr, flush=True))


@dataclass
class Outcome:
    """What a runner returns: the end-to-end values by name, the per-layer
    reading context, the numbers compared by name, and the run's counts."""

    values: Dict[str, float]
    layer: Optional[Dict]
    compared: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    device: Dict


def window(step: Callable[[int], None], seconds: float, sync: Callable[[], None],
           whole: int = 1):
    """Run ``step(i)`` from i = 0 until ``seconds`` of host time have passed
    and the steps run are a multiple of ``whole`` (whole passes over the
    pool: every seed's window holds the same work), then wait for the
    device; (steps run, wall seconds)."""
    sync()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds or i % whole:
        step(i)
        i += 1
    sync()
    return i, time.perf_counter() - t0


def traced(step: Callable[[int], None], steps: int, sync: Callable[[], None], path: Path,
           ranges):
    """``steps`` calls of ``step``, each in a "step" range of ``ranges``,
    under the profiler (after one warm-up call of its own), the chrome trace
    written to ``path`` and read back; (the Trace, the traced window's wall
    seconds)."""
    from perfbench.trace import Trace, profile

    with profile(steps) as prof:
        step(-1)
        sync()
        prof.step()
        ranges.reset()
        t0 = time.perf_counter()
        for i in range(steps):
            with ranges.span("step"):
                step(i)
            if i == steps - 1:  # the last kernels finish inside the recorded cycle
                sync()
                wall = time.perf_counter() - t0
            prof.step()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    del prof
    tr = Trace(str(path), ranges.log, ranges.marks)
    path.unlink()
    return tr, wall


def judge(compared: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at or under its limit."""
    return all(name in limits and math.isfinite(v) and v <= limits[name]
               for name, v in compared.items())


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment(ROOT)
    err = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    try:
        bench = benchmark(ROOT)
        cell = cell_of(bench, args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise BenchError(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        config = config_of(bench, ROOT, cell["config"])
        mix = mix_of(ROOT, cell["traffic"])
        ctx = Context(cell=cell, config=config, mix=mix, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t0=t0, limits=limits_of(ROOT, cell["name"]), log=err)
        out = runner_of(mix).run(ctx)
    except BenchError as e:
        err(f"perfbench: {e}")
        return 2
    found = forbidden_modules()
    if found:
        err(f"perfbench: modules of JAX or the JAX package were loaded: {found}")
        return 3
    if args.trace:
        names = [m for m in cell_metrics(bench, cell["name"], "per_layer")]
        metrics = {}
        for m in names:
            v = reader(ROOT, m["name"])(out.layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell["name"], "end_to_end")}
    correct = judge(out.compared, ctx.limits)
    checks = {k: {"value": v, "limit": ctx.limits.get(k)} for k, v in out.compared.items()}
    from perfbench.runners.common import power_limit

    err(f"perfbench: card {power_limit()}")  # a card may run under its 700 W
    for k, c in checks.items():
        err(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    device = dict(out.device)
    device["memory_peak_bytes"] = out.peak_bytes
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if args.trace and out.layer is not None and out.layer.get("breakdown"):
        line["breakdown"] = out.layer["breakdown"]
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
