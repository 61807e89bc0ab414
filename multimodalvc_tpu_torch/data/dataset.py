"""AVSR / speech / pretraining datasets: manifest-driven samples, bucketed
collation, and the loader that feeds the card.

Port of ``multimodalvc_tpu/data/dataset.py``.  ``PretrainDataset`` serves
AV-HuBERT pretraining (video, stacked filterbanks, k-means labels).
``AVSRDataset`` decodes and
transforms the video, reads the audio (babble noise on the train subset),
computes the Whisper features, tokenizes the transcript with the constant
instruction, and, for the speech tasks, the mel targets and the waveform;
``collate`` pads to the bucket shapes of the JAX package (video to the
length bucket, labels to ``max_label_tokens``, mels to ``max_mel_frames``,
audio features to 30 s), so both packages see the same batches.

``BatchLoader`` replaces the JAX ``PrefetchLoader`` (a thread pool):
``torch.utils.data.DataLoader`` over the precomputed batch list, one
collated batch an item, in ``num_workers`` worker *processes*, numpy turned
into CPU tensors in the worker, pinned when the batches go to the card.
Workers never touch the card.  A worker reseeds the dataset's generators
for each batch from (seed, epoch, the batch's position in the epoch), so
every worker draws its own crops, flips and SNRs and a run gives the same
batches at any worker count >= 1 and after a mid-epoch resume.  With
``num_workers=0`` the batches load in the calling process from the
dataset's one generator, as the JAX dataset's sequential ``dataset[i]``
draws do.  So 0 workers give other train-time draws than 1 or more, and a
0-worker mid-epoch resume draws, as the JAX loader's resume does, from a
fresh generator: its batches are the straight run's in their clips, not in
their crops, flips and noise.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .audio import NoiseMixer, hifigan_mel_np, read_wav, stacked_logfbank_np, whisper_features_np
from .batching import batch_by_size, bucket_for, pad_to
from .manifest import load_manifest, resolve_path
from .tokenizer import INSTRUCTION_TEXT, load_tokenizer
from .video import load_video_frames, transform_video

logger = logging.getLogger(__name__)

IGNORE_INDEX = -100


@dataclass
class AVSRDatasetConfig:
    manifest_dir: str = ""
    subset: str = "train"
    llm_path: Optional[str] = None
    modalities: Sequence[str] = ("video", "audio")
    image_crop_size: int = 88
    image_mean: float = 0.421
    image_std: float = 0.165
    image_aug: bool = False
    noise_wav: Optional[str] = None
    noise_prob: float = 0.0
    noise_snr: Optional[float] = None  # a fixed SNR for evaluation sweeps
    max_video_frames: int = 500
    min_video_frames: int = 5
    max_label_tokens: int = 96
    length_buckets: Sequence[int] = (100, 200, 300, 400, 500)
    # which targets to produce
    with_text_labels: bool = True
    with_mel_targets: bool = False
    with_waveform: bool = False
    max_mel_frames: int = 2400
    seed: int = 1


class AVSRDataset:
    def __init__(self, cfg: AVSRDatasetConfig):
        self.cfg = cfg
        tsv = os.path.join(cfg.manifest_dir, f"{cfg.subset}.tsv")
        wrd = os.path.join(cfg.manifest_dir, f"{cfg.subset}.wrd")
        self.manifest = load_manifest(
            tsv,
            max_keep_frames=cfg.max_video_frames,
            min_keep_frames=cfg.min_video_frames,
            label_path=wrd if (cfg.with_text_labels and os.path.exists(wrd)) else None,
        )
        self.tokenizer = load_tokenizer(cfg.llm_path)
        self.instruction = np.asarray(self.tokenizer.encode(INSTRUCTION_TEXT), np.int32)
        self.noise = NoiseMixer(cfg.noise_wav, seed=cfg.seed) if cfg.noise_wav else None
        self.rng = np.random.default_rng(cfg.seed)
        self.is_train = cfg.subset == "train"

    def __len__(self):
        return len(self.manifest)

    def sizes(self) -> List[int]:
        return self.manifest.sizes()

    def reseed(self, *key: int) -> None:
        """New augmentation generators (crops and flips; noise segments and
        SNRs) from ``key``."""
        self.rng = np.random.default_rng([self.cfg.seed, *key, 0])
        if self.noise is not None:
            self.noise.rng = np.random.default_rng([self.cfg.seed, *key, 1])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        e = self.manifest.entries[index]
        out: Dict[str, np.ndarray] = {"id": np.asarray(index)}

        if "video" in cfg.modalities:
            frames = load_video_frames(resolve_path(self.manifest.root, e.video_path))
            out["video"] = transform_video(
                frames, crop_size=cfg.image_crop_size, mean=cfg.image_mean, std=cfg.image_std,
                train=self.is_train and cfg.image_aug, rng=self.rng)
            out["video_length"] = np.asarray(out["video"].shape[0], np.int32)

        if "audio" in cfg.modalities:
            wav = read_wav(resolve_path(self.manifest.root, e.audio_path))
            mix = (
                self.is_train and self.noise is not None and self.rng.random() < cfg.noise_prob
            ) or (not self.is_train and self.noise is not None and cfg.noise_prob >= 1.0)
            if mix:
                wav = self.noise(wav, cfg.noise_snr)
            out["audio_length"] = np.asarray(len(wav), np.int32)
            out["audio_feats"] = whisper_features_np(wav)
            if cfg.with_waveform:
                out["waveform"] = wav.astype(np.float32)
            if cfg.with_mel_targets:
                mel_path = os.path.splitext(
                    resolve_path(self.manifest.root, e.audio_path))[0] + "_mel_100hz_128bands.npy"
                if os.path.exists(mel_path):
                    out["target_mel"] = np.load(mel_path).astype(np.float32)
                else:  # computed on the fly (the offline extractor's math)
                    out["target_mel"] = hifigan_mel_np(wav)

        if cfg.with_text_labels and self.manifest.labels is not None:
            ids = self.tokenizer.encode(self.manifest.labels[index]) + [
                self.tokenizer.eos_token_id]
            out["labels"] = np.asarray(ids[: cfg.max_label_tokens], np.int32)
        out["speech_rate"] = np.asarray(e.speech_rate, np.float32)
        return out

    # -- batching -------------------------------------------------------------

    def batches(self, max_tokens: Optional[int] = 1000, batch_size: Optional[int] = None,
                required_multiple: int = 1, epoch: int = 0) -> List[np.ndarray]:
        return batch_by_size(
            self.sizes(), max_tokens=max_tokens, batch_size=batch_size,
            buckets=self.cfg.length_buckets, required_multiple=required_multiple,
            shuffle_seed=(self.cfg.seed + epoch) if self.is_train else None)

    def collate(self, samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """Pad to the batch's bucket shapes."""
        cfg = self.cfg
        batch: Dict[str, np.ndarray] = {}
        b = len(samples)
        if "video" in samples[0]:
            vid_lens = np.asarray([s["video_length"] for s in samples], np.int32)
            t_v = bucket_for(int(vid_lens.max()), cfg.length_buckets)
            batch["video"] = np.stack([pad_to(s["video"], t_v) for s in samples])
            batch["video_lengths"] = vid_lens
        if "audio_feats" in samples[0]:
            batch["audio_feats"] = np.stack([s["audio_feats"] for s in samples])
            batch["audio_lengths"] = np.asarray([s["audio_length"] for s in samples], np.int32)
        if "labels" in samples[0]:
            lab_lens = np.asarray([len(s["labels"]) for s in samples], np.int32)
            batch["labels"] = np.stack(
                [pad_to(s["labels"], cfg.max_label_tokens, value=0) for s in samples])
            batch["label_lengths"] = lab_lens
            batch["instruction"] = np.tile(self.instruction[None], (b, 1))
        if "target_mel" in samples[0]:
            mel_lens = np.asarray([s["target_mel"].shape[0] for s in samples], np.int32)
            batch["target_mel"] = np.stack(
                [pad_to(s["target_mel"], cfg.max_mel_frames) for s in samples])
            batch["target_mel_lengths"] = np.minimum(mel_lens, cfg.max_mel_frames)
        if "waveform" in samples[0]:
            t_w = cfg.max_mel_frames * 160
            batch["waveform"] = np.stack(
                [pad_to(s["waveform"], t_w)[..., None] for s in samples])
        batch["ids"] = np.asarray([int(s["id"]) for s in samples], np.int32)
        return batch

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        """The collated batch of ``indices``, in order."""
        return self.collate([self[int(i)] for i in indices])


class PretrainDataset:
    """AV-HuBERT masked-pretraining samples: the video, the stacked log
    filterbank (``stacked_logfbank_np``) and the frame-level k-means labels
    of a ``.km`` file (one space-separated row a manifest clip, written by
    ``cli.manifest_tools dump-labels``), decimated from ``label_rate`` to the
    25 Hz frame rate and cut to the shortest of the three; ``collate`` pads
    to the length bucket.  On the train subset the crops and flips are drawn
    from ``self.rng``, seeded by ``seed`` (the JAX dataset draws them from an
    unseeded generator); ``reseed`` gives the loader's workers theirs."""

    def __init__(self, manifest_dir: str, subset: str, km_path: Optional[str] = None,
                 label_rate: int = 100, max_video_frames: int = 500, image_crop_size: int = 88,
                 length_buckets: Sequence[int] = (100, 200, 300, 400, 500), seed: int = 1):
        tsv = os.path.join(manifest_dir, f"{subset}.tsv")
        self.manifest = load_manifest(tsv, max_keep_frames=max_video_frames)
        km = km_path or os.path.join(manifest_dir, f"{subset}.km")
        with open(km) as f:
            rows = f.read().splitlines()
        decim = max(label_rate // 25, 1)  # decimate to the 25 Hz frame rate
        self.labels = [np.asarray(r.split(), np.int32)[::decim] for r in rows]
        if len(self.labels) < len(self.manifest.entries):
            raise ValueError(
                f"{km}: {len(self.labels)} label rows < {len(self.manifest.entries)} clips")
        self.crop = image_crop_size
        self.buckets = tuple(length_buckets)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.is_train = subset == "train"

    def __len__(self):
        return len(self.manifest.entries)

    def sizes(self) -> List[int]:
        return self.manifest.sizes()

    def reseed(self, *key: int) -> None:
        """A new crop and flip generator from ``key``."""
        self.rng = np.random.default_rng([self.seed, *key, 0])

    def batches(self, max_tokens: Optional[int] = 1000, batch_size: Optional[int] = None,
                required_multiple: int = 1, epoch: int = 0) -> List[np.ndarray]:
        return batch_by_size(
            self.sizes(), max_tokens=max_tokens, batch_size=batch_size, buckets=self.buckets,
            required_multiple=required_multiple,
            shuffle_seed=(self.seed + epoch) if self.is_train else None)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        e = self.manifest.entries[index]
        root = self.manifest.root
        video = transform_video(load_video_frames(resolve_path(root, e.video_path)),
                                crop_size=self.crop, train=self.is_train, rng=self.rng)
        audio = stacked_logfbank_np(read_wav(resolve_path(root, e.audio_path)))
        t = min(len(video), len(audio), len(self.labels[index]))
        return {
            "video": video[:t],
            "audio": audio[:t],
            "targets": self.labels[index][:t],
            "length": np.asarray(t, np.int32),
        }

    def collate(self, samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        t_max = bucket_for(max(int(s["length"]) for s in samples), self.buckets)
        return {
            "video": np.stack([pad_to(s["video"], t_max) for s in samples]),
            "audio": np.stack([pad_to(s["audio"], t_max) for s in samples]),
            "targets": np.stack([pad_to(s["targets"], t_max) for s in samples]).astype(np.int32),
            "lengths": np.asarray([s["length"] for s in samples], np.int32),
        }

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        """The collated batch of ``indices``, in order."""
        return self.collate([self[int(i)] for i in indices])


def to_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy -> CPU tensors (the memory shared, not copied)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """The batch on ``device``, each copy queued without waiting (from pinned
    memory the copies overlap the card's work)."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class _EpochBatches(torch.utils.data.Dataset):
    """One collated batch an item; ``first`` is the position in the epoch of
    the first batch (batches before it were consumed before a resume)."""

    def __init__(self, dataset: AVSRDataset, batches: List[np.ndarray], epoch: int, first: int):
        self.dataset, self.batches, self.epoch, self.first = dataset, batches, epoch, first

    def __len__(self):
        return len(self.batches)

    def __getitem__(self, k: int) -> Dict[str, torch.Tensor]:
        if torch.utils.data.get_worker_info() is not None:
            self.dataset.reseed(self.epoch, self.first + k)
        return to_tensors(self.dataset.load_batch(self.batches[k]))


def _identity(batch):
    return batch


class BatchLoader:
    """Iterate the collated batches of ``batches`` (CPU tensors, pinned with
    ``pin_memory``) in order, loaded in ``num_workers`` worker processes
    (two batches ahead each, as the JAX loader's prefetch), or in this
    process with 0."""

    def __init__(self, dataset: AVSRDataset, batches: List[np.ndarray], num_workers: int = 0,
                 epoch: int = 0, first: int = 0, pin_memory: bool = False):
        self.dataset = dataset
        self.batches = list(batches)
        self.num_workers = num_workers
        self.epoch, self.first = epoch, first
        self.pin_memory = pin_memory

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        if not self.batches:
            return iter(())
        kw = dict(prefetch_factor=2) if self.num_workers > 0 else {}
        return iter(torch.utils.data.DataLoader(
            _EpochBatches(self.dataset, self.batches, self.epoch, self.first),
            batch_size=None, shuffle=False, num_workers=self.num_workers,
            collate_fn=_identity, pin_memory=self.pin_memory, **kw))
