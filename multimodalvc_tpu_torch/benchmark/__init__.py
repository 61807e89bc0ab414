"""Throughput dummy tasks: fabricated batches, real models.

Port of ``multimodalvc_tpu/benchmark/__init__.py`` (reference:
fairseq/fairseq/benchmark/dummy_{lm,mt,masked_lm}.py, tasks that fabricate
batches so that training throughput can be measured without a corpus).
``dummy_avsr`` drives the full AVSR train step through the normal command
line::

    python -m multimodalvc_tpu_torch.cli.train task.name=dummy_avsr \\
        model.name=mms_llama_avsr optimization.max_update=3

The batch is drawn once from ``np.random.default_rng(seed)``, in the JAX
task's draw order, so both packages fabricate the same arrays: the audio
features of a full 30 s Whisper window, the video, the lengths (``t_v`` x
640 audio samples), the instruction and the labels.  Every batch of an
epoch is that batch.  The task is ``AVSRTask`` with its own dataset: the
system is built as ``AVSRTask`` builds it (on the given device, in the
given dtype, with ``init_random``).  Its ``prepare_batch`` takes the
``train`` flag that ``cli.train`` passes to every task (the JAX one does
not, so the JAX loop's validation of this task raises a ``TypeError``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..config.registry import register_task
from ..models.avsr import AVSRConfig
from ..tasks import AVSRTask


@dataclass
class DummyAVSRTaskConfig:
    data: str = ""  # unused
    batch_size: int = 4
    video_frames: int = 100
    crop: int = 88
    label_tokens: int = 24
    n_batches: int = 50
    seed: int = 0


class _DummyDataset:
    """Duck-typed dataset: fabricated AVSR batches, no disk IO.  Fits
    ``cli.train``'s loop (``batches``) and ``data/dataset.py:
    BatchLoader`` (``load_batch``, ``reseed``)."""

    def __init__(self, cfg: DummyAVSRTaskConfig, model_cfg: AVSRConfig):
        self.cfg = cfg
        self.model_cfg = model_cfg
        rng = np.random.default_rng(cfg.seed)
        b, t_v = cfg.batch_size, cfg.video_frames
        mc = model_cfg
        self._batch = {
            "audio_feats": rng.standard_normal(
                (b, mc.whisper.n_mels, 2 * mc.whisper.max_frames)).astype(np.float32),
            "video": rng.standard_normal((b, t_v, cfg.crop, cfg.crop, 1)).astype(np.float32),
            "video_lengths": np.full((b,), t_v, np.int32),
            "audio_lengths": np.full((b,), t_v * 640, np.int32),
            "instruction": rng.integers(1, 200, (b, 8)).astype(np.int32),
            "labels": rng.integers(1, min(mc.llama.vocab_size, 200),
                                   (b, cfg.label_tokens)).astype(np.int32),
            "label_lengths": np.full((b,), cfg.label_tokens, np.int32),
        }

    def __len__(self):
        return self.cfg.n_batches * self.cfg.batch_size

    def batches(self, max_tokens=None, batch_size=None, required_multiple=1, epoch=0):
        b = self.cfg.batch_size
        return [np.arange(i * b, (i + 1) * b) for i in range(self.cfg.n_batches)]

    def __getitem__(self, index: int):
        return index

    def collate(self, samples) -> Dict[str, np.ndarray]:
        return dict(self._batch)

    def load_batch(self, indices) -> Dict[str, np.ndarray]:
        return self.collate([self[int(i)] for i in indices])

    def reseed(self, epoch: int, position: int) -> None:
        """Nothing to reseed: every batch is the one fabricated batch."""


@register_task("dummy_avsr", config=DummyAVSRTaskConfig)
class DummyAVSRTask(AVSRTask):
    """``AVSRTask`` over fabricated batches (throughput benchmarking)."""

    def load_dataset(self, subset: str) -> _DummyDataset:
        return _DummyDataset(self.cfg, self.model_cfg)

    def prepare_batch(self, batch, train: bool = True):
        return batch
