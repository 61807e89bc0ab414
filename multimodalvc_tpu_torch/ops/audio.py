"""Waveform-level ops: SNR noise mixing and PCM conversion.

Port of ``multimodalvc_tpu/ops/audio.py``: babble-noise augmentation at a
random SNR from {-5, 0, 5, 10, 15, 20} dB on the train subset, or a fixed SNR
for evaluation sweeps.  ``add_noise_snr`` takes numpy arrays (the host data
pipeline, bit for bit the JAX package's host path) or torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch

SNR_LEVELS = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0)


def add_noise_snr(speech, noise, snr_db, eps: float = 1e-10):
    """Mix ``noise`` into ``speech`` at a target SNR in dB.

    torchaudio's formula: the noise is scaled so that
    10 * log10(P_speech / P_noise_scaled) == snr_db; leading batch dims
    broadcast."""
    if isinstance(speech, torch.Tensor):
        speech_power = (speech ** 2).sum(dim=-1, keepdim=True)
        noise_power = (noise ** 2).sum(dim=-1, keepdim=True)
        snr = 10.0 ** (torch.as_tensor(snr_db, dtype=speech.dtype, device=speech.device) / 10.0)
        scale = torch.sqrt(speech_power / (snr * noise_power + eps) + eps)
        return speech + scale * noise
    speech_power = np.sum(speech ** 2, axis=-1, keepdims=True)
    noise_power = np.sum(noise ** 2, axis=-1, keepdims=True)
    snr = 10.0 ** (np.asarray(snr_db, dtype=speech.dtype) / 10.0)
    scale = np.sqrt(speech_power / (snr * noise_power + eps) + eps)
    return speech + scale * noise


def sample_noise_segment(noise: np.ndarray, length: int, rng: np.random.Generator) -> np.ndarray:
    """A random contiguous segment of the (long) noise track, tiled if short."""
    if noise.shape[-1] < length:
        reps = -(-length // noise.shape[-1])
        noise = np.tile(noise, reps)
    start = int(rng.integers(0, noise.shape[-1] - length + 1))
    return noise[..., start : start + length]


def pcm16_to_float(wav: np.ndarray) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1)."""
    if wav.dtype == np.int16:
        return (wav / 32768.0).astype(np.float32)
    return wav.astype(np.float32)
