"""Mel-spectrogram loss and the speech-quality metrics (MCD, SSIM).

Port of ``multimodalvc_tpu/criterions/mel.py``: the masked L1 on 128-band
log-mels with per-sample lengths (the training loss), and at validation
the mel cepstral distortion (DCT-II cepstra) and a Gaussian-window SSIM.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.interpolate import length_mask
from ..parallel.mesh import batch_total


def masked_l1(pred: torch.Tensor, target: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean |pred - target| over the valid frames, [B, T, D]: the sum over
    them divided by max(frames * D, 1) (on a mesh the batch group's frames:
    the rank's share of the global mean)."""
    mask = length_mask(lengths, pred.shape[1], dtype=pred.dtype)[..., None]
    diff = (pred - target).abs() * mask
    return diff.sum() / torch.clamp(batch_total(mask.sum()) * pred.shape[-1], min=1.0)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Type-II DCT rows [n_mfcc, n_mels]."""
    k = np.arange(n_mfcc)[:, None]
    n = np.arange(n_mels)[None, :]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_mels)) * math.sqrt(2.0 / n_mels)
    return m.astype(np.float32)


def compute_mcd(pred: torch.Tensor, target: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, n_mfcc: int = 13) -> torch.Tensor:
    """Mel cepstral distortion in dB over the valid frames (the energy
    coefficient skipped)."""
    m = torch.from_numpy(dct_matrix(n_mfcc, pred.shape[-1])).to(pred.device, pred.dtype)
    diff = (pred @ m.T)[..., 1:] - (target @ m.T)[..., 1:]
    frame = torch.sqrt(torch.clamp((diff ** 2).sum(dim=-1), min=1e-12))  # [B, T]
    if lengths is not None:
        mask = length_mask(lengths, pred.shape[1], dtype=frame.dtype)
        mean = (frame * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        mean = frame.mean()
    return (10.0 * math.sqrt(2.0) / math.log(10.0)) * mean


def _gauss_kernel(window: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(window) - window // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def compute_ssim(pred: torch.Tensor, target: torch.Tensor, window: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM of [B, T, D] spectrograms taken as images: each
    local moment is the 11x11 Gaussian window over the reflect-padded image."""
    data_range = torch.clamp(torch.maximum(target.max() - target.min(),
                                           pred.max() - pred.min()), min=1e-6)
    kern = torch.from_numpy(_gauss_kernel(window)).to(pred.device, pred.dtype)[None, None]
    pad = window // 2

    def filt(x):
        return F.conv2d(F.pad(x[:, None], (pad, pad, pad, pad), mode="reflect"), kern)[:, 0]

    mu_p, mu_t = filt(pred), filt(target)
    s_pp = filt(pred * pred) - mu_p ** 2
    s_tt = filt(target * target) - mu_t ** 2
    s_pt = filt(pred * target) - mu_p * mu_t
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (s_pp + s_tt + c2))
    return ssim_map.mean()


@dataclass
class MelL1Config:
    report_mcd: bool = True
    report_ssim: bool = True


class MelL1Criterion:
    """Training: the masked mel L1 (loss and mel_l1); validation adds mcd and
    ssim.  The model's mel and the target are cut to the shorter of the
    two, and each row to the shorter of its two lengths; the loss and the
    metrics are computed in f32 (a bf16 model's mel is widened)."""

    def __init__(self, cfg: Optional[MelL1Config] = None):
        self.cfg = cfg or MelL1Config()

    def __call__(self, model_out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                 train: bool = True):
        pred, target = model_out["melspec"], batch["target_mel"]
        t = min(pred.shape[1], target.shape[1])
        pred_t, target_t = pred[:, :t].float(), target[:, :t].float()
        lengths = torch.clamp(torch.minimum(model_out["mel_lengths"],
                                            batch["target_mel_lengths"].to(model_out["mel_lengths"])),
                              max=t)
        loss = masked_l1(pred_t, target_t, lengths)
        total = batch_total(loss)
        metrics = {"loss": total, "mel_l1": total}
        if not train:
            if self.cfg.report_mcd:
                metrics["mcd"] = compute_mcd(pred_t, target_t, lengths)
            if self.cfg.report_ssim:
                metrics["ssim"] = compute_ssim(pred_t, target_t)
        return loss, metrics
