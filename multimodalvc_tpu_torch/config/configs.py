"""The root training configuration tree and its groups.

A copy of ``multimodalvc_tpu/config/configs.py`` (the same groups, fields and
defaults), so that a preset such as ``conf/mms-llama.yaml`` configures both
packages alike.  The port reads the mesh group only to refuse what it cannot
run: it trains on one card in one process (``cli/train.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from .structured import MISSING


@dataclass
class CommonConfig:
    seed: int = 1
    log_interval: int = 100
    log_format: str = "simple"  # simple | json
    tensorboard_logdir: Optional[str] = None
    # extra metric sinks; each does nothing when unset or when its client
    # package is absent
    wandb_project: Optional[str] = None
    azureml_logging: bool = False
    metrics_jsonl: Optional[str] = None  # append-only JSONL metrics stream
    # the dtype the modules compute in (the trainer keeps f32 masters)
    compute_dtype: str = "bfloat16"
    profile: bool = False
    profile_dir: str = "profiles"
    # log when one optimizer step blocks longer than this (0 = off)
    step_timeout_s: float = 0.0
    # the JAX package's recompile guard (no compiled step here)
    max_compilations: int = 4


@dataclass
class MeshConfig:
    """Device-mesh layout: -1 on one axis fills it with the devices left."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    sequence: int = 1
    expert: int = 1
    pipeline: int = 1
    # number of microbatches when pipeline > 1
    microbatches: int = 1


@dataclass
class DatasetConfig:
    data: str = MISSING  # manifest directory
    train_subset: str = "train"
    valid_subset: str = "valid"
    batch_size: Optional[int] = None
    max_tokens: Optional[int] = 1000  # video frames budget per batch
    num_workers: int = 4
    required_batch_size_multiple: int = 8
    skip_invalid_size_inputs_valid_test: bool = True
    validate_interval: int = 1
    # skip validation; checkpoints then track the training loss
    disable_validation: bool = False
    # beam-decode this many validation batches a validation pass and report
    # the corpus WER (-1 = all, 0 = off); enables best_checkpoint_metric: wer
    valid_wer_batches: int = 0
    # samples are padded up to the nearest bucket boundary
    length_buckets: Tuple[int, ...] = (100, 200, 300, 400, 500)


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


@dataclass
class GenerationConfig:
    beam: int = 5
    max_len: int = 100
    min_len: int = 1
    temperature: float = 0.3
    length_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    # weight-only quantized decode: None | "int8" | "int4"
    weight_quant: Optional[str] = None
    # beam reorder: None = the ancestry decode on the card, the gather
    # reorder on the CPU; True / False force it
    ancestry_decode: Optional[bool] = None
    # KV-cache format: None (bf16) | "int8" (implies the ancestry decode)
    kv_cache_quant: Optional[str] = None
    # run the encoders and the prompt assembly in N sequential chunks
    encoder_microbatch: int = 0
    # lexically constrained decoding: None | "unordered" | "ordered"
    constraints: Optional[str] = None
    # line N: the tab-separated constraint phrases of manifest sample N
    constraints_file: Optional[str] = None


@dataclass
class TrainRootConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    task: Dict[str, Any] = field(default_factory=dict)  # includes 'name'
    model: Dict[str, Any] = field(default_factory=dict)  # includes 'name'
    criterion: Dict[str, Any] = field(default_factory=dict)  # includes 'name'
