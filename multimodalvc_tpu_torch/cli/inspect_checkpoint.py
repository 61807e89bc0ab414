"""Inspect a checkpoint: its keys, their shapes and the parameter counts by prefix.

Port of ``multimodalvc_tpu/cli/inspect_checkpoint.py``::

  python -m multimodalvc_tpu_torch.cli.inspect_checkpoint model.pt --depth 2 [--keys]

Reads a torch ``.pt`` / ``.pth`` file (``runtime/pt_loader.py: load_pt``,
so nothing in it executes), a checkpoint directory of the port
(``runtime/checkpoint.py``'s ``state.pt``) or the JAX package's numpy
fallback (``arrays.npz``).  An orbax directory needs the JAX package and is
refused.
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..runtime.checkpoint import STATE_FILE
from ..runtime.pt_loader import flatten_state_dict, load_pt


def flat_items(path: str) -> List[Tuple[str, torch.Tensor]]:
    """The (key, tensor) pairs of the checkpoint at ``path``, sorted by key."""
    if path.endswith((".pt", ".pth")):
        return sorted(flatten_state_dict(load_pt(path)).items())
    if os.path.isdir(path):
        state = os.path.join(path, STATE_FILE)
        if os.path.exists(state):
            return sorted(flatten_state_dict(load_pt(state)).items())
        npz = os.path.join(path, "arrays.npz")
        if os.path.exists(npz):
            data = np.load(npz)
            return sorted((k, torch.from_numpy(data[k])) for k in data.files)
        raise SystemExit(f"cannot read {path}: no {STATE_FILE} or arrays.npz in it (an orbax "
                         "checkpoint needs the JAX package's inspect_checkpoint)")
    raise SystemExit(f"unsupported checkpoint path {path}")


def summarize(items, depth: int = 2) -> Tuple[int, int, Dict[str, List[int]]]:
    """(keys, parameters, {prefix: [keys, parameters]}) with the keys grouped
    by their first ``depth`` dotted parts."""
    groups: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    total = 0
    for key, val in items:
        prefix = ".".join(str(key).replace("/", ".").split(".")[:depth])
        groups[prefix][0] += 1
        groups[prefix][1] += val.numel()
        total += val.numel()
    return len(items), total, dict(groups)


def main(argv=None) -> Tuple[int, int]:
    parser = argparse.ArgumentParser()
    parser.add_argument("path", help=".pt file, a checkpoint directory, or a numpy checkpoint dir")
    parser.add_argument("--depth", type=int, default=2, help="prefix grouping depth")
    parser.add_argument("--keys", action="store_true", help="print every key")
    args = parser.parse_args(argv)

    items = flat_items(args.path)
    if args.keys:
        for key, val in items:
            print(f"{key}\t{tuple(val.shape)}\t{str(val.dtype).removeprefix('torch.')}")
    n_keys, total, groups = summarize(items, args.depth)
    print(f"{n_keys} keys, {total / 1e6:.2f}M params — prefixes at depth {args.depth}:")
    for prefix in sorted(groups):
        n, p = groups[prefix]
        print(f"  {prefix:50s} {n:5d} keys {p / 1e6:10.2f}M")
    return n_keys, total


if __name__ == "__main__":
    main()
