"""Run cells of the benchmark several times, one process a run, and keep
every result line; then the spread of each metric.

    python3 perfbench/series.py --out DIR --seconds S [--trace 0|1] CELL:SEED[,SEED...] ...

Each run is ``perfbench/run.py`` as the contract's command gives it; its
standard output and error go to ``DIR/<cell>_<seed>_t<trace>.{out,err}`` and
its result line (with its wall seconds) to ``DIR/results.jsonl``.  Then, for
each cell, each metric's median and its spread: the distance between the
first and third quartiles (``statistics.quantiles(values, n=4)``) over the
median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("runs", nargs="+", help="CELL:SEED[,SEED...]")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values = defaultdict(lambda: defaultdict(list))
    for spec in args.runs:
        cell, seeds = spec.split(":")
        for seed in seeds.split(","):
            cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", cell,
                   "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            stem = out / f"{cell}_{seed}_t{args.trace}"
            stem.with_suffix(".out").write_text(proc.stdout)
            stem.with_suffix(".err").write_text(proc.stderr)
            lines = proc.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            rec = {"cell": cell, "seed": int(seed), "trace": args.trace, "rc": proc.returncode,
                   "wall_s": wall, "result": result}
            with open(out / "results.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
            short = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
            print(json.dumps({"cell": cell, "seed": int(seed), "rc": proc.returncode,
                              "wall_s": round(wall, 1),
                              "correct": (result or {}).get("correct"), "metrics": short,
                              "checks": (result or {}).get("checks")}), flush=True)
            if proc.returncode:
                print(proc.stderr[-3000:], flush=True)
            for k, v in short.items():
                values[cell][k].append(v)
    for cell, metrics in values.items():
        for k, vs in metrics.items():
            print(f"{cell} {k}: median {statistics.median(vs)!r} spread {spread(vs)!r} "
                  f"n {len(vs)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
