"""Which trainable leaves the fsdp axis splits, and along which dim.

Port of the fallback rule of ``multimodalvc_tpu/parallel/sharding.py``
(``_fsdp_fallback_spec``): a leaf whose largest dim is at least
``FSDP_MIN_SIZE`` is split along its largest dim that the fsdp size divides
(the first of equal ones); smaller leaves stay whole.  The rule applies to
the port's shapes (torch's [out, in] weights).  Under fsdp the trainer
keeps only its share of a split leaf's f32 master and optimizer moments
(ZeRO-3 for the optimizer state, ``runtime/trainer.py``); the module's
weights, frozen ones included, stay whole on every rank.

The tensor-parallel rules (``TRANSFORMER_TP_RULES``) wait with the tensor
axis (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Optional, Sequence

FSDP_MIN_SIZE = 1024


def fsdp_shard_dim(shape: Sequence[int], fsdp_size: int) -> Optional[int]:
    """The dim the fsdp axis splits a leaf of ``shape`` along, or None."""
    if fsdp_size <= 1 or not shape or max(shape) < FSDP_MIN_SIZE:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % fsdp_size == 0:
            return d
    return None
