"""Process-group bootstrap: one process per device.

Port of ``multimodalvc_tpu/parallel/distributed.py``.  The JAX package makes
the whole job one ``jax.distributed`` cluster; here every rank is one
process that drives one device, joined by a ``torch.distributed`` process
group (NCCL on CUDA, gloo on the CPU).  The mesh's axes are groups of those
ranks (``parallel/mesh.py``).

Rendezvous sources, in priority order (the reference's, fairseq
``distributed/utils.py:47-148``):
  1. a group that a launcher or the caller already started: kept as it is;
  2. torchrun's variables: ``MASTER_ADDR`` + ``MASTER_PORT`` + ``WORLD_SIZE``
     + ``RANK`` (and ``LOCAL_RANK``), the env:// path;
  3. SLURM: ``SLURM_NTASKS`` > 1 with ``SLURM_PROCID`` / ``SLURM_LOCALID``,
     the first host of ``SLURM_JOB_NODELIST`` (or ``MASTER_ADDR``) as the
     address and ``MASTER_PORT`` (default 29500) as the port.
A world of one process initialises nothing, as in JAX, unless forced.

The TPU launch variables (``COORDINATOR_ADDRESS``, ``TPU_WORKER_HOSTNAMES``,
``MEGASCALE_*``) and the slice-aware device layout (``hybrid_device_array``,
``num_granules``) have no counterpart: the mesh's rank order puts pipeline
and data outermost, so the other axes' groups stay inside a node.

Data flow: each rank loads its own share of the batches
(``data/batching.py: shard_batches`` keyed by the batch-group rank); a step
on N data ranks computes the step on the concatenation of their batches.
"""
from __future__ import annotations

import logging
import os
import re
from datetime import timedelta
from typing import Dict, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_PORT = 29500


def _first_slurm_host(nodelist: str) -> str:
    """The first host of a SLURM node list: "a,b" -> "a", "gpu[03-06,9]" -> "gpu03"."""
    m = re.match(r"([^,\[]+)(\[([^\]]+)\])?", nodelist.strip())
    if m is None:
        raise ValueError(f"cannot read SLURM_JOB_NODELIST {nodelist!r}")
    prefix, _, ranges = m.groups()
    if not ranges:
        return prefix
    return prefix + ranges.split(",")[0].split("-")[0]


def infer_init_args() -> Optional[Dict]:
    """How to rendezvous, from the environment: ``init_method``,
    ``world_size``, ``rank`` and ``local_rank`` for ``distributed_init``, or
    None when nothing signals a launch of more than one process."""
    env = os.environ
    if all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        world = int(env["WORLD_SIZE"])
        if world <= 1:
            return None
        return {"init_method": f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                "world_size": world, "rank": int(env["RANK"]),
                "local_rank": int(env.get("LOCAL_RANK", "0"))}
    if env.get("SLURM_JOB_ID") and int(env.get("SLURM_NTASKS", "1")) > 1:
        addr = env.get("MASTER_ADDR") or _first_slurm_host(env.get("SLURM_JOB_NODELIST", ""))
        port = int(env.get("MASTER_PORT", DEFAULT_PORT))
        return {"init_method": f"tcp://{addr}:{port}", "world_size": int(env["SLURM_NTASKS"]),
                "rank": int(env.get("SLURM_PROCID", "0")),
                "local_rank": int(env.get("SLURM_LOCALID", "0"))}
    return None


def distributed_init(backend: Optional[str] = None, force: bool = False,
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, timeout: Optional[timedelta] = None) -> int:
    """Start the process group if the environment (or the arguments) say
    this is a launch of several processes; returns the world size.

    ``backend`` defaults to NCCL with a GPU and gloo without (the smoke and
    the CPU tests pass "gloo").  With a GPU the process binds
    ``cuda:local_rank`` (``LOCAL_RANK``).  ``force`` starts a group even for
    one process (torchrun's env:// variables with ``WORLD_SIZE=1``), so that
    the distributed step runs at world size 1.  ``init_method``,
    ``world_size`` and ``rank`` given here take the place of the
    environment's (a ``file://`` rendezvous in the tests).  A group that
    already exists is kept, as the JAX function keeps a runtime a launcher
    started."""
    if dist.is_initialized():
        return dist.get_world_size()
    kw = infer_init_args() or {}
    if init_method is not None:
        kw.update(init_method=init_method, world_size=world_size or 1, rank=rank or 0)
    if not kw:
        if not force:
            return 1
        kw = {"init_method": "env://"}
    local_rank = kw.pop("local_rank", int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank)
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend=backend, **kw)
    logger.info("distributed: rank %d/%d (%s, local rank %d)", dist.get_rank(),
                dist.get_world_size(), backend, local_rank)
    return dist.get_world_size()


def is_master() -> bool:
    """True on the process that writes checkpoints and metric sinks (the
    reference gates on distributed_rank == 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def destroy() -> None:
    """Tear the process group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
