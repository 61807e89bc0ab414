"""The readings that the limits of ``correct`` are set from.

    python3 perfbench/control.py --cell CELL --seeds S1,...,S12 --control-seeds C1,C2,C3

In one process, for the cell at its own size: the program's sound readings
(each seed's set-up as a run makes it, the numbers a run compares), then on
the control seeds the control's (the reference computed in float8 e4m3 in
the program's place) and, for a training cell, the faults' (``half_batch``:
the loss over half of each batch's rows; ``no_update``: the step leaves the
state unchanged).  Prints one JSON line a reading, then each number's lower
reading (the largest sound one) and upper reading (the smallest of the
control and the faults).  The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402
from perfbench.runners import synth, train  # noqa: E402

FAULTS = ("half_batch", "no_update")


def _free(device: str) -> None:
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def train_readings(ctx, seed: int, control: bool, faults=FAULTS) -> List[Dict]:
    n = ctx.mix["compare_steps"]
    out = []
    prog = train.Program(ctx, seed)
    got = prog.first_steps(n, rest=False)
    first = prog.batches[:n]
    del prog
    _free(ctx.device)
    want = train.reference_steps(ctx, seed, first, n)
    out.append({"kind": "sound", "seed": seed, **train.compare(got, want),
                "worst": train.worst_leaves(got, want)})
    if control:
        ctrl = train.reference_steps(ctx, seed, first, n, precision="fp8")
        out.append({"kind": "control_fp8", "seed": seed, **train.compare(ctrl, want),
                    "worst": train.worst_leaves(ctrl, want)})
        for fault in faults:
            prog = train.Program(ctx, seed, fault=fault)
            bad = prog.first_steps(n, rest=False)
            del prog
            _free(ctx.device)
            out.append({"kind": f"fault_{fault}", "seed": seed, **train.compare(bad, want)})
    return out


def synth_readings(ctx, seed: int, control: bool, faults=()) -> List[Dict]:
    out = []
    prog = synth.Program(ctx, seed)
    with torch.inference_mode():
        for b in range(len(prog.batches)):
            prog.batch(b)
    got, batches, ids, clips = prog.got, prog.batches, prog.batches_ids, sorted(prog.wanted)
    del prog
    _free(ctx.device)
    want = synth.reference_outputs(ctx, seed, batches, ids, clips)
    out.append({"kind": "sound", "seed": seed, **synth.compare(got, want)})
    if control:
        ctrl = synth.reference_outputs(ctx, seed, batches, ids, clips, precision="fp8")
        out.append({"kind": "control_fp8", "seed": seed, **synth.compare(ctrl, want)})
        for fault in faults:
            prog = synth.Program(ctx, seed, fault=fault)
            with torch.inference_mode():
                for b in range(len(prog.batches)):
                    prog.batch(b)
            bad = prog.got
            del prog
            _free(ctx.device)
            out.append({"kind": f"fault_{fault}", "seed": seed, **synth.compare(bad, want)})
    return out


def summary(rows: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Each number's lower reading (the largest sound one) and upper reading
    (the smallest other one)."""
    names = [k for k in rows[0] if k not in ("kind", "seed", "worst")]
    out = {}
    for k in names:
        sound = [r[k] for r in rows if r["kind"] == "sound"]
        other = [r[k] for r in rows if r["kind"] != "sound"]
        out[k] = {"lower": max(sound), "upper": min(other) if other else None,
                  "sound_seeds": len(sound)}
    return out


def readings(ctx, seeds, control_seeds, faults=None) -> List[Dict]:
    fn = train_readings if ctx.mix["runner"] == "train" else synth_readings
    kw = {} if faults is None else {"faults": faults}
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        for r in fn(ctx, seed, control=seed in control_seeds, **kw):
            r["s"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
            rows.append({k: v for k, v in r.items() if k not in ("s", "worst")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="half_batch",
                    help="a training cell's faults run on the control seeds (no_update reads 1)")
    args = ap.parse_args(argv)
    harness.set_environment(harness.ROOT)
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.cell)
    ctx = harness.Context(cell=cell, config=harness.config_of(bench, harness.ROOT, cell["config"]),
                          mix=harness.mix_of(harness.ROOT, cell["traffic"]), seed=0, seconds=0,
                          trace=False)
    control = [int(s) for s in args.control_seeds.split(",") if s]
    seeds = [int(s) for s in args.seeds.split(",")] + [s for s in control]
    seeds = list(dict.fromkeys(seeds))
    faults = tuple(f for f in args.faults.split(",") if f)
    rows = readings(ctx, seeds, set(control), faults if ctx.mix["runner"] == "train" else ())
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
