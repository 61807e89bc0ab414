"""Pretraining-label clustering: MFCC features and mini-batch k-means.

Port of ``multimodalvc_tpu/data/clustering.py``: ``mfcc_np`` (39-dim MFCC +
deltas at 100 Hz, host numpy over the port's STFT tables, bit for bit the
JAX features) and ``MiniBatchKMeans`` with its centroids on the torch
device.  The init and each epoch's permutation are the JAX numpy draws
(``default_rng(seed)``); a batch's step is Sculley's running-mean update.
Assignment is one f32 product minus half the centroids' squared norms and
an ``argmax`` (ties to the first centroid); the products run at full f32
precision (``ops/stft.py: exact_matmul``), so TF32 cannot flip a near-tied
assignment on the card.  The labels feed AV-HuBERT pretraining
(``models/avhubert_pretrain.py``).
"""
from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..criterions.mel import dct_matrix
from ..ops.stft import exact_matmul
from .audio import htk_logmel_np, read_wav
from .manifest import resolve_path

logger = logging.getLogger(__name__)


def mfcc_np(
    wav: np.ndarray,
    sample_rate: int = 16000,
    n_mfcc: int = 13,
    n_mels: int = 26,
    n_fft: int = 400,
    hop: int = 160,
    deltas: bool = True,
) -> np.ndarray:
    """[T] -> [T // hop, 39] MFCC + delta + delta-delta at 100 Hz (the
    cepstra of 26 HTK mel bands from 20 Hz, natural log floored at 1e-10)."""
    logmel = htk_logmel_np(wav, sample_rate, n_mels, n_fft, hop)
    mfcc = logmel @ dct_matrix(n_mfcc, n_mels).T
    if not deltas:
        return mfcc.astype(np.float32)

    def delta(feat: np.ndarray, n: int = 2) -> np.ndarray:
        denom = 2 * sum(i * i for i in range(1, n + 1))
        padded = np.pad(feat, ((n, n), (0, 0)), mode="edge")
        out = np.zeros_like(feat)
        for i in range(1, n + 1):
            out += i * (padded[n + i: n + i + len(feat)] - padded[n - i: n - i + len(feat)])
        return out / denom

    d1 = delta(mfcc)
    d2 = delta(d1)
    return np.concatenate([mfcc, d1, d2], axis=1).astype(np.float32)


def assign(feats: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, D], [K, D] f32 -> [N] int32 nearest-centroid ids: argmax of x.c -
    ||c||^2 / 2 (||x - c||^2 without the ||x||^2 that argmin ignores)."""
    scores = exact_matmul(feats, centroids.T) - 0.5 * (centroids * centroids).sum(dim=1)[None, :]
    return scores.argmax(dim=1).to(torch.int32)


def minibatch_update(feats: torch.Tensor, centroids: torch.Tensor, counts: torch.Tensor):
    """One MiniBatchKMeans step (Sculley'10): each centroid's running mean
    with per-assignment learning rates.  Returns (centroids, counts,
    inertia), the inertia against the updated centroids."""
    k = centroids.shape[0]
    one_hot = F.one_hot(assign(feats, centroids).long(), k).to(feats.dtype)  # [N, K]
    batch_counts = one_hot.sum(dim=0)
    new_counts = counts + batch_counts
    sums = exact_matmul(one_hot.T.contiguous(), feats)  # [K, D]
    lr = torch.where(new_counts > 0, 1.0 / torch.clamp(new_counts, min=1.0), 0.0)
    centroids = centroids + lr[:, None] * (sums - batch_counts[:, None] * centroids)
    inertia = (feats * feats).sum() - (one_hot * exact_matmul(feats, centroids.T)).sum()
    return centroids, new_counts, inertia


class MiniBatchKMeans:
    """Mini-batch k-means with its centroids on ``device`` while it fits
    (``centroids``: numpy f32 [K, D] after ``fit`` or ``load``);
    ``epoch_inertia`` holds each epoch's last-batch inertia, which the fit
    logs."""

    def __init__(self, n_clusters: int, batch_size: int = 10000, seed: int = 0, device="cuda"):
        self.k = n_clusters
        self.batch_size = batch_size
        self.seed = seed
        self.device = torch.device(device)
        self.centroids: Optional[np.ndarray] = None
        self.epoch_inertia: List[float] = []

    def _on_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    @torch.no_grad()
    def fit(self, feats: np.ndarray, epochs: int = 5) -> "MiniBatchKMeans":
        rng = np.random.default_rng(self.seed)
        n = len(feats)
        init_idx = rng.choice(n, size=self.k, replace=n < self.k)
        centroids = self._on_device(feats[init_idx])
        counts = torch.zeros(self.k, dtype=torch.float32, device=self.device)
        self.epoch_inertia = []
        for epoch in range(epochs):
            order = rng.permutation(n)
            inertia = torch.zeros((), device=self.device)
            for s in range(0, n - self.batch_size + 1, self.batch_size) or [0]:
                batch = self._on_device(feats[order[s: s + self.batch_size]])
                centroids, counts, inertia = minibatch_update(batch, centroids, counts)
            self.epoch_inertia.append(float(inertia))
            logger.info("kmeans epoch %d inertia %.4g", epoch, self.epoch_inertia[-1])
        self.centroids = centroids.cpu().numpy()
        return self

    @torch.no_grad()
    def predict(self, feats: np.ndarray) -> np.ndarray:
        if self.centroids is None:
            raise RuntimeError("fit first")
        return assign(self._on_device(feats), self._on_device(self.centroids)).cpu().numpy()

    def save(self, path: str) -> None:
        np.save(path, self.centroids)

    @classmethod
    def load(cls, path: str, device="cuda") -> "MiniBatchKMeans":
        c = np.load(path)
        km = cls(n_clusters=len(c), device=device)
        km.centroids = c
        return km


def manifest_audio_paths(tsv_path: str) -> List[str]:
    """The audio path of each clip row of a manifest .tsv (rows with fewer
    than three columns skipped), resolved against its root line."""
    with open(tsv_path) as f:
        root = f.readline().strip()
        rows = [line.rstrip("\n").split("\t") for line in f]
    return [resolve_path(root, cols[2].split(":")[0]) for cols in rows if len(cols) >= 3]


def dump_labels_for_manifest(tsv_path: str, km: MiniBatchKMeans, out_path: str,
                             feature_fn=mfcc_np) -> int:
    """Write one space-separated label row a manifest clip (the ``.km`` file
    pretraining reads); returns the rows written."""
    n = 0
    with open(out_path, "w") as out:
        for path in manifest_audio_paths(tsv_path):
            labels = km.predict(feature_fn(read_wav(path)))
            out.write(" ".join(map(str, labels.tolist())) + "\n")
            n += 1
    return n
