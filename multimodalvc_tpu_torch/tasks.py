"""Task layer: couples the AVSR model, its trainer loss and its validation.

Port of ``AVSRTask`` in ``multimodalvc_tpu/tasks.py`` without
``load_dataset`` (the data loaders are not ported yet): the batch
preparation, the trainer loss, the frozen patterns and the validation step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .criterions.lm import lm_metrics
from .models.avsr import AVSRConfig, AVSRSystem


def _trim_audio_feats(batch: Dict[str, torch.Tensor], whisper_frames: int) -> Dict[str, torch.Tensor]:
    """Cut the fixed 30 s Whisper features down to the model's window."""
    af = batch.get("audio_feats")
    if af is not None and af.shape[-1] > 2 * whisper_frames:
        batch = dict(batch)
        batch["audio_feats"] = af[..., : 2 * whisper_frames]
    return batch


@dataclass
class AVSRTaskConfig:
    """The task group's field the port reads; the data fields (manifest,
    noise, buckets, augmentation) come with the data loaders."""

    pipeline_microbatches: int = 0  # > 0: the pipelined LLaMA loss, not ported yet


class AVSRTask:
    """LM-loss AVSR fine-tuning."""

    BATCH_KEYS = ("video", "video_lengths", "audio_feats", "audio_lengths", "instruction",
                  "labels", "label_lengths")

    def __init__(self, cfg: AVSRTaskConfig, model_cfg: Optional[AVSRConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or AVSRConfig()
        self.system = AVSRSystem(self.model_cfg, dtype=dtype, device=device)

    def prepare_batch(self, batch: Dict[str, torch.Tensor], train: bool = True):
        batch = _trim_audio_feats(batch, self.model_cfg.whisper.max_frames)
        return {k: batch[k] for k in self.BATCH_KEYS if k in batch}

    def make_loss_fn(self):
        if getattr(self.cfg, "pipeline_microbatches", 0) > 0:
            raise NotImplementedError("the pipelined LLaMA loss is not ported yet")
        return self.system.make_trainer_loss_fn()

    def frozen_patterns(self):
        return self.system.frozen_patterns()

    def valid_step_fn(self):
        module = self.system.module

        @torch.no_grad()
        def valid_step(batch):
            return lm_metrics(*module(batch, train=False))

        return valid_step
