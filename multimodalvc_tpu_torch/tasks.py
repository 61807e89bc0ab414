"""Task layer: couples datasets, models and criterions for the command line.

Port of ``multimodalvc_tpu/tasks.py``: for the AVSR LM loss (``AVSRTask``),
the speech heads' mel regression (``SpeechTask``), the standalone vocoder
(``VocoderTask``), the E2E GAN (``E2EGanTask``) and AV-HuBERT's masked
pretraining (``AVHubertPretrainTask``), the dataset of each subset (``load_dataset``), the batch
preparation, the trainer loss or trainer, the frozen patterns, the
validation step and, for AVSR, the beam decode to text.  The tasks are
registered under the JAX package's names, which the presets' ``task.name``
give.  The speech tasks draw each training batch's modality mode from their
own ``np.random.default_rng(7)``, as the JAX tasks do, so both packages give
a run the same modes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config.registry import register_task
from .criterions.gan import E2EGanConfig, E2EGanTrainer
from .criterions.lm import lm_metrics
from .criterions.mel import MelL1Config, MelL1Criterion
from .data.dataset import AVSRDataset, AVSRDatasetConfig, PretrainDataset
from .models.avhubert_pretrain import AVHubertPretrainConfig, AVHubertPretrainModel
from .models.avsr import AVSRConfig, AVSRSystem
from .models.speech import SpeechConfig, SpeechE2EModel, SpeechLLMModel, SpeechNoLLMModel
from .models.vocoder import VocoderConfig, VocoderModel
from .nn.hifigan import HifiGanConfig
from .nn.init import init_random_
from .parallel.mesh import batch_total, get_current_mesh
from .runtime.tracing import span


def _trim_audio_feats(batch: Dict[str, torch.Tensor], whisper_frames: int) -> Dict[str, torch.Tensor]:
    """Cut the fixed 30 s Whisper features down to the model's window."""
    af = batch.get("audio_feats")
    if af is not None and af.shape[-1] > 2 * whisper_frames:
        batch = dict(batch)
        batch["audio_feats"] = af[..., : 2 * whisper_frames]
    return batch


@dataclass
class AVSRTaskConfig:
    data: str = ""
    llm_path: Optional[str] = None
    noise_wav: Optional[str] = None
    noise_prob: float = 0.25
    noise_snr: Optional[float] = None
    modalities: tuple = ("video", "audio")
    max_video_frames: int = 500
    max_label_tokens: int = 96
    length_buckets: tuple = (100, 200, 300, 400, 500)
    image_aug: bool = True
    pipeline_microbatches: int = 0  # > 0: the pipelined LLaMA loss on a pipeline axis


@register_task("avsr_training", config=AVSRTaskConfig)
class AVSRTask:
    """LM-loss AVSR fine-tuning.  The system's config is ``model_cfg``
    itself, so the special-token ids that ``load_dataset`` sets reach
    ``generate``."""

    BATCH_KEYS = ("video", "video_lengths", "audio_feats", "audio_lengths", "instruction",
                  "labels", "label_lengths")

    def __init__(self, cfg: AVSRTaskConfig, model_cfg: Optional[AVSRConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or AVSRConfig()
        self.system = AVSRSystem(self.model_cfg, dtype=dtype, device=device)

    @classmethod
    def from_config(cls, cfg, model_cfg=None, dtype=torch.float32, device="cuda"):
        return cls(cfg, model_cfg, dtype, device)

    @property
    def module(self) -> torch.nn.Module:
        return self.system.module

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        self.system.init_random(seed)

    def load_dataset(self, subset: str) -> AVSRDataset:
        """The subset's dataset: noise on the train subset (on the others only
        at a fixed ``noise_snr``); the model's eos and pad ids follow the
        tokenizer."""
        c = self.cfg
        ds = AVSRDataset(AVSRDatasetConfig(
            manifest_dir=c.data,
            subset=subset,
            llm_path=c.llm_path,
            modalities=c.modalities,
            noise_wav=c.noise_wav,
            noise_prob=c.noise_prob if subset == "train" else (
                c.noise_prob if c.noise_snr is not None else 0.0),
            noise_snr=c.noise_snr,
            max_video_frames=c.max_video_frames,
            max_label_tokens=c.max_label_tokens,
            length_buckets=tuple(c.length_buckets),
            image_aug=c.image_aug,
            with_text_labels=True,
        ))
        self.model_cfg.eos_token_id = ds.tokenizer.eos_token_id
        self.model_cfg.pad_token_id = ds.tokenizer.pad_token_id
        return ds

    def prepare_batch(self, batch: Dict[str, torch.Tensor], train: bool = True):
        batch = _trim_audio_feats(batch, self.model_cfg.whisper.max_frames)
        return {k: batch[k] for k in self.BATCH_KEYS if k in batch}

    def make_loss_fn(self):
        """The pipelined loss when ``pipeline_microbatches`` > 0 and the
        current mesh has more than one pipeline stage, else the plain one
        (as the JAX task)."""
        if getattr(self.cfg, "pipeline_microbatches", 0) > 0:
            mesh = get_current_mesh()
            if mesh is not None and mesh.size("pipeline") > 1:
                return self.system.make_pipeline_loss_fn(mesh, self.cfg.pipeline_microbatches)
        return self.system.make_trainer_loss_fn()

    def frozen_patterns(self):
        return self.system.frozen_patterns()

    def valid_step_fn(self):
        module = self.system.module

        @torch.no_grad()
        def valid_step(batch):
            return lm_metrics(*module(batch, train=False))

        return valid_step

    def decode_to_text(self, batch: Dict[str, torch.Tensor], ids, dataset: AVSRDataset,
                       generation_cfg, constraints_by_id=None,
                       ensemble: Sequence[AVSRSystem] = ()) -> Tuple[List[str], List[str]]:
        """Beam-decode one prepared batch to (hypotheses, references) text,
        for evaluation and for validation-time WER.  ``constraints_by_id``
        maps a manifest sample id to its constraint phrases (token lists); a
        batch with none keeps the unconstrained path.  ``ensemble``: further
        systems that decode with this one (log-prob averaged)."""
        tok = dataset.tokenizer
        gen_batch = {k: v for k, v in batch.items() if k not in ("labels", "label_lengths")}
        cons_kw = {}
        if constraints_by_id:
            batch_cons = [constraints_by_id.get(int(i), []) for i in ids]
            if any(batch_cons):
                cons_kw = dict(constraints=batch_cons,
                               constraints_mode=generation_cfg.constraints or "unordered")
        seqs, _ = self.system.generate(
            gen_batch,
            num_beams=generation_cfg.beam,
            max_new_tokens=generation_cfg.max_len,
            length_penalty=generation_cfg.length_penalty,
            no_repeat_ngram_size=generation_cfg.no_repeat_ngram_size,
            ancestry_reorder=generation_cfg.ancestry_decode,
            kv_quant=generation_cfg.kv_cache_quant,
            encoder_microbatch=generation_cfg.encoder_microbatch,
            ensemble=ensemble,
            **cons_kw,
        )
        best = seqs[:, 0].cpu().numpy()
        hyps: List[str] = []
        refs: List[str] = []
        for row, sample_id in zip(best, ids):
            toks = []
            for tkn in row.tolist():
                if tkn == self.model_cfg.eos_token_id:
                    break
                toks.append(tkn)
            hyps.append(tok.decode(toks))
            refs.append(dataset.manifest.labels[int(sample_id)] if dataset.manifest.labels
                        else "")
        return hyps, refs


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
        mode = int(self.rng.choice(3, p=self.p))
        with span("train.mode.wait"):  # a host number copied to the device
            return torch.tensor(mode, dtype=torch.int32, device=like.device)


def _take(batch, keys) -> Dict[str, torch.Tensor]:
    return {k: batch[k] for k in keys if k in batch}


@register_task("speech_training", config=SpeechTaskConfig)
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

    @classmethod
    def from_config(cls, cfg, model_cfg=None, dtype=torch.float32, device="cuda"):
        return cls(cfg, model_cfg, dtype, device)

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.module, seed)

    def load_dataset(self, subset: str) -> AVSRDataset:
        """The subset's dataset with mel targets (and the transcripts with
        the instruction for the "llm" variant); no augmentation."""
        c = self.cfg
        return AVSRDataset(AVSRDatasetConfig(
            manifest_dir=c.data,
            subset=subset,
            llm_path=c.llm_path,
            modalities=c.modalities,
            max_video_frames=c.max_video_frames,
            length_buckets=tuple(c.length_buckets),
            with_text_labels=c.variant == "llm",
            with_mel_targets=True,
            max_mel_frames=c.max_mel_frames,
        ))

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
    data: str = ""
    segment_length: int = 8320
    lr: float = 1e-4


@register_task("vocoder_training", config=VocoderTaskConfig)
class VocoderTask:
    """Standalone HiFi-GAN training: ``VocoderModel`` and its batches.  The
    generator trains in f32, as the JAX task's does, whatever the compute
    dtype (the E2E task keeps its generator in f32 too)."""

    def __init__(self, cfg: VocoderTaskConfig, model_cfg: Optional[VocoderConfig] = None,
                 device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or VocoderConfig(lr=cfg.lr, segment_length=cfg.segment_length)
        self.model = VocoderModel(self.model_cfg, device=device)

    @classmethod
    def from_config(cls, cfg, model_cfg=None, dtype=None, device="cuda"):
        """``dtype`` (the compute dtype) is not used: see the class."""
        return cls(cfg, model_cfg, device)

    def load_dataset(self, subset: str) -> AVSRDataset:
        """The audio of the subset: mel targets and waveforms padded or cut
        to one segment."""
        return AVSRDataset(AVSRDatasetConfig(
            manifest_dir=self.cfg.data,
            subset=subset,
            modalities=("audio",),
            with_text_labels=False,
            with_mel_targets=True,
            with_waveform=True,
            max_mel_frames=self.model_cfg.segment_length // 160,
        ))

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


@register_task("e2e_gan_training", config=E2EGanTaskConfig)
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

    @classmethod
    def from_config(cls, cfg, model_cfg=None, dtype=torch.float32, device="cuda"):
        return cls(cfg, model_cfg, dtype, device)

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.model, seed)

    def load_dataset(self, subset: str) -> AVSRDataset:
        """The subset's dataset with mel targets and waveforms."""
        c = self.cfg
        return AVSRDataset(AVSRDatasetConfig(
            manifest_dir=c.data,
            subset=subset,
            modalities=c.modalities,
            max_video_frames=c.max_video_frames,
            length_buckets=tuple(c.length_buckets),
            with_text_labels=False,
            with_mel_targets=True,
            with_waveform=True,
            max_mel_frames=c.max_mel_frames,
        ))

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


@dataclass
class AVHubertPretrainTaskConfig:
    data: str = ""
    km_path: Optional[str] = None  # defaults to <data>/<subset>.km
    max_video_frames: int = 500
    image_crop_size: int = 88
    length_buckets: tuple = (100, 200, 300, 400, 500)
    loss_unmasked_weight: float = 0.0  # pred_nomask weighting (large_vox: 0)


@register_task("avhubert_pretraining", config=AVHubertPretrainTaskConfig)
class AVHubertPretrainTask:
    """AV-HuBERT masked pretraining on k-means cluster labels (the labels
    from ``cli.manifest_tools learn-kmeans`` / ``dump-labels``).  The module
    is built on ``device`` in ``dtype``; nothing is frozen."""

    def __init__(self, cfg: AVHubertPretrainTaskConfig,
                 model_cfg: Optional[AVHubertPretrainConfig] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg or AVHubertPretrainConfig()
        self.module = AVHubertPretrainModel(self.model_cfg, device=device, dtype=dtype).eval()

    @classmethod
    def from_config(cls, cfg, model_cfg=None, dtype=torch.float32, device="cuda"):
        return cls(cfg, model_cfg, dtype, device)

    def init_random(self, seed: int = 0) -> None:
        """Random weights from ``seed`` (``init_random_``)."""
        init_random_(self.module, seed)

    def load_dataset(self, subset: str) -> PretrainDataset:
        c = self.cfg
        return PretrainDataset(manifest_dir=c.data, subset=subset, km_path=c.km_path,
                               max_video_frames=c.max_video_frames,
                               image_crop_size=c.image_crop_size,
                               length_buckets=tuple(c.length_buckets))

    def prepare_batch(self, batch: Dict[str, torch.Tensor], train: bool = True):
        return batch

    def frozen_patterns(self) -> List[str]:
        return []

    def make_loss_fn(self):
        """(batch, generator) -> (loss, metrics) for ``Trainer``: the training
        forward (span masks from ``generator``, the ResNet on batch
        statistics, which move the running ones); loss_masked +
        loss_unmasked_weight * loss_unmasked."""
        module, w_u = self.module, self.cfg.loss_unmasked_weight

        def loss_fn(batch, generator):
            out = module(batch["audio"], batch["video"], batch["targets"], batch["lengths"],
                         train=True, generator=generator)
            loss = out["loss_masked"] + w_u * out["loss_unmasked"]
            return loss, {"loss_masked": batch_total(out["loss_masked"]),
                          "acc_masked": out["acc_masked"]}

        return loss_fn

    def valid_step_fn(self):
        """No masking at evaluation: the loss over every valid frame, and, as
        in the JAX task, ``acc_masked`` (0, with no masked frame) as the
        accuracy."""
        module = self.module

        @torch.no_grad()
        def valid_step(batch):
            out = module(batch["audio"], batch["video"], batch["targets"], batch["lengths"],
                         train=False)
            return {"loss": out["loss_unmasked"], "accuracy": out["acc_masked"]}

        return valid_step
