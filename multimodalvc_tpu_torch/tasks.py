"""Task layer: couples each model with its trainer loss and its validation.

Port of ``multimodalvc_tpu/tasks.py`` without ``load_dataset`` (the data
loaders are not ported yet): for the AVSR LM loss (``AVSRTask``), the
speech heads' mel regression (``SpeechTask``), the standalone vocoder
(``VocoderTask``) and the E2E GAN (``E2EGanTask``), the batch preparation,
the trainer loss or trainer, the frozen patterns and the validation step.
The speech tasks draw each training batch's modality mode from their own
``np.random.default_rng(7)``, as the JAX tasks do, so both packages give a
run the same modes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .criterions.gan import E2EGanConfig, E2EGanTrainer
from .criterions.lm import lm_metrics
from .criterions.mel import MelL1Config, MelL1Criterion
from .models.avsr import AVSRConfig, AVSRSystem
from .models.speech import SpeechConfig, SpeechE2EModel, SpeechLLMModel, SpeechNoLLMModel
from .models.vocoder import VocoderConfig, VocoderModel
from .nn.hifigan import HifiGanConfig
from .nn.init import init_random_


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


@dataclass
class SpeechTaskConfig(AVSRTaskConfig):
    variant: str = "nollm"  # llm | nollm (e2e: E2EGanTask)
    max_mel_frames: int = 2400
    p_modality_av: float = 0.5
    p_modality_video_only: float = 0.25
    p_modality_audio_only: float = 0.25


class _ModeDraw:
    """The training batches' modality mode (0 both streams, 1 video only, 2
    audio only), one draw a prepared training batch."""

    def __init__(self, cfg: SpeechTaskConfig):
        self.p = [cfg.p_modality_av, cfg.p_modality_video_only, cfg.p_modality_audio_only]
        self.rng = np.random.default_rng(7)

    def __call__(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(int(self.rng.choice(3, p=self.p)), dtype=torch.int32,
                            device=like.device)


def _take(batch, keys) -> Dict[str, torch.Tensor]:
    return {k: batch[k] for k in keys if k in batch}


class SpeechTask:
    """Mel-regression training of a speech head: "nollm" (``SpeechNoLLMModel``
    with modality dropout) or "llm" (``SpeechLLMModel``, LLaMA frozen but
    its LoRA adapters).  The module is built on ``device`` in ``dtype``."""

    BATCH_KEYS = ("video", "video_lengths", "audio_feats", "audio_lengths", "instruction",
                  "target_mel", "target_mel_lengths")

    def __init__(self, cfg: SpeechTaskConfig, model_cfg: Optional[SpeechConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or SpeechConfig()
        kw = dict(device=device, dtype=dtype)
        if cfg.variant == "llm":
            self.module = SpeechLLMModel(self.model_cfg, **kw).eval()
        elif cfg.variant == "nollm":
            self.model_cfg.modality_dropout = True
            self.module = SpeechNoLLMModel(self.model_cfg, **kw).eval()
        else:
            raise ValueError(f"variant {cfg.variant} (e2e trains through E2EGanTask)")
        self.criterion = MelL1Criterion(MelL1Config())
        self._mode = _ModeDraw(cfg)

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.module, seed)

    def prepare_batch(self, batch: Dict[str, torch.Tensor], train: bool = True):
        """The model's keys, the Whisper features cut to its window and, in
        training only, the batch's modality mode."""
        out = _take(_trim_audio_feats(batch, self.model_cfg.whisper.max_frames), self.BATCH_KEYS)
        if self.cfg.variant == "llm" and "instruction" not in out:
            raise ValueError("llm variant needs instruction tokens")
        if train:
            out["modality_mode"] = self._mode(out["video"])
        return out

    def frozen_patterns(self) -> List[str]:
        pats = [r"encoder/whisper/", r"encoder/avhubert/", r"encoder/sr_predictor/"]
        if self.cfg.variant == "llm":
            pats.append(r"^llama/")
        return pats

    def make_loss_fn(self):
        """(batch, generator) -> (loss, metrics) for ``Trainer``: the training
        forward (dropout from ``generator``, BatchNorm batch statistics,
        which move the running ones) and the masked mel L1."""
        module, criterion = self.module, self.criterion

        def loss_fn(batch, generator):
            return criterion(module(batch, train=True, generator=generator), batch, train=True)

        return loss_fn

    def valid_step_fn(self):
        module, criterion = self.module, self.criterion

        @torch.no_grad()
        def valid_step(batch):
            return criterion(module(batch, train=False), batch, train=False)[1]

        return valid_step


@dataclass
class VocoderTaskConfig:
    segment_length: int = 8320
    lr: float = 1e-4


class VocoderTask:
    """Standalone HiFi-GAN training: ``VocoderModel`` and its batches."""

    def __init__(self, cfg: VocoderTaskConfig, model_cfg: Optional[VocoderConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or VocoderConfig(lr=cfg.lr, segment_length=cfg.segment_length)
        self.model = VocoderModel(self.model_cfg, dtype=dtype, device=device)

    def prepare_batch(self, batch: Dict[str, torch.Tensor], train: bool = True):
        """The segment's mel frames and samples: {"mel", "wav"}."""
        seg = self.model_cfg.segment_length
        return {"mel": batch["target_mel"][:, : seg // 160], "wav": batch["waveform"][:, :seg]}


@dataclass
class E2EGanTaskConfig(SpeechTaskConfig):
    # stage 1 trains the generator and its conv_pre adapter only; stage 2
    # (False) the whole model but the frozen encoders
    stage1_freeze: bool = True
    gen_lr: float = 2e-4
    disc_lr: float = 2e-4
    vocoder_initial_channels: int = 512
    vocoder_resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    disc_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    disc_scales: int = 3
    disc_channels_cap: int = 1024


class E2EGanTask:
    """E2E waveform training with the HiFi-GAN two-optimizer step
    (``criterions/gan.py``).  The model (``SpeechE2EModel``, modality dropout
    on) is built on ``device`` in ``dtype`` but its generator, which is f32
    as the discriminators and the STFT are."""

    BATCH_KEYS = ("video", "video_lengths", "audio_feats", "audio_lengths", "target_mel",
                  "target_mel_lengths", "waveform")

    def __init__(self, cfg: E2EGanTaskConfig, model_cfg: Optional[SpeechConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or SpeechConfig()
        self.model_cfg.modality_dropout = True
        nk = len(cfg.vocoder_resblock_kernels)
        voc = HifiGanConfig(in_channels=self.model_cfg.head_dim,
                            upsample_initial_channel=cfg.vocoder_initial_channels,
                            resblock_kernel_sizes=tuple(cfg.vocoder_resblock_kernels),
                            resblock_dilations=((1, 3, 5),) * nk)
        self.model = SpeechE2EModel(self.model_cfg, voc, device=device, dtype=dtype).eval()
        self.model.generator.float()
        self.gan_cfg = E2EGanConfig(gen_lr=cfg.gen_lr, disc_lr=cfg.disc_lr,
                                    disc_periods=tuple(cfg.disc_periods),
                                    disc_scales=cfg.disc_scales,
                                    disc_channels_cap=cfg.disc_channels_cap)
        self._mode = _ModeDraw(cfg)

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.model, seed)

    def frozen_patterns(self) -> List[str]:
        if not self.cfg.stage1_freeze:
            return [r"trunk/encoder/whisper/", r"trunk/encoder/avhubert/",
                    r"trunk/encoder/sr_predictor/"]
        return [r"^trunk/"]  # stage 1: the generator and its conv_pre adapter train

    def make_trainer(self, seed: int = 0) -> E2EGanTrainer:
        """The GAN trainer with this stage's frozen leaves (its
        discriminators random from ``seed``)."""
        return E2EGanTrainer(self.gan_cfg, self.model, self.frozen_patterns(), seed)

    def prepare_batch(self, batch: Dict[str, torch.Tensor], train: bool = True):
        out = _take(_trim_audio_feats(batch, self.model_cfg.whisper.max_frames), self.BATCH_KEYS)
        if train:
            out["modality_mode"] = self._mode(out["video"])
        return out
