"""The optimization and checkpoint configuration groups.

A copy of ``OptimizationConfig`` and ``CheckpointConfig`` from
``multimodalvc_tpu/config/configs.py`` (same fields, same defaults), so that
a preset such as ``conf/mms-llama.yaml`` configures both packages alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class OptimizationConfig:
    max_update: int = 30000
    max_epoch: int = 0
    lr: float = 1e-4
    optimizer: str = "adamw"
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    update_freq: int = 1  # gradient accumulation steps
    lr_scheduler: str = "cosine"
    warmup_updates: int = 500
    min_lr: float = 1e-6
    # manual scheduler milestones: {step: lr}
    lr_milestones: Optional[Dict[str, float]] = None
    # triangular scheduler: the full cycle in updates (0 -> 2 * warmup_updates)
    # and the per-cycle peak shrink (1.0: no annealing)
    lr_period_updates: int = 0
    lr_shrink: float = 1.0
    # tri_stage phase fractions (warmup, hold, decay) of max_update; None
    # keeps the warmup_updates-based split with a 40% hold
    phase_ratio: Optional[Tuple[float, float, float]] = None
    # reduce_lr_on_plateau: shrink the LR by lr_shrink after lr_patience + 1
    # validations without a relative improvement > lr_threshold;
    # plateau_maximize follows checkpoint.maximize_best_checkpoint_metric
    lr_patience: int = 0
    lr_threshold: float = 1e-4
    plateau_maximize: bool = False
    # skip a step whose gradients are not finite
    skip_nonfinite_grads: bool = True


@dataclass
class CheckpointConfig:
    save_dir: str = "checkpoints"
    save_interval_updates: int = 0
    keep_interval_updates: int = -1
    keep_last_epochs: int = -1
    keep_best_checkpoints: int = 1
    best_checkpoint_metric: str = "loss"
    maximize_best_checkpoint_metric: bool = False
    patience: int = -1
    reset_optimizer: bool = False
    # checkpoint name, or a comma-separated list for an eval-time ensemble
    restore_file: str = "checkpoint_last"
    # how a multi-checkpoint restore combines members: "logprob" (a
    # log-prob-averaged ensemble decode) or "average" (parameter averaging)
    ensemble_mode: str = "logprob"
    # with a multi-member restore_file, a missing member raises instead of
    # silently decoding a smaller ensemble
    strict_ensemble: bool = True
    # torch .pt checkpoint to import weights from
    init_from_pt: Optional[str] = None
    async_save: bool = True
