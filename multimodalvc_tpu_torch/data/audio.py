"""Host-side audio: WAV IO, babble-noise augmentation, log-mel features.

Port of ``multimodalvc_tpu/data/audio.py``, bit for bit its host numpy code:
scipy wavfile read, int16 -> [-1, 1), train-time noise mixing at a random
SNR, Whisper's 80-bin features padded to 30 s, HiFi-GAN's 128-band mel
targets and AV-HuBERT's stacked log filterbanks.  The DFT basis and the filterbanks are the port's own
(``ops/stft.py``), the same numpy tables as the JAX package's.  These run in
the loader's worker processes: numpy only, never the card.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
from scipy.io import wavfile

from ..ops import stft as stft_ops
from ..ops.audio import SNR_LEVELS, add_noise_snr, pcm16_to_float, sample_noise_segment

logger = logging.getLogger(__name__)


def read_wav(path: str, expected_sr: int = 16000) -> np.ndarray:
    sr, data = wavfile.read(path)
    if sr != expected_sr:
        raise ValueError(f"{path}: sample rate {sr} != {expected_sr}")
    if data.ndim > 1:
        data = data[:, 0]
    return pcm16_to_float(data)


def write_wav(path: str, wav: np.ndarray, sr: int = 16000) -> None:
    wavfile.write(path, sr, np.clip(wav, -1.0, 1.0).astype(np.float32))


class NoiseMixer:
    """Babble-noise augmentation: a random segment of the noise track at a
    random SNR (or ``snr_db``), drawn from ``self.rng``."""

    def __init__(self, noise_wav_path: Optional[str], seed: int = 0):
        self.noise = read_wav(noise_wav_path) if noise_wav_path else None
        self.rng = np.random.default_rng(seed)

    def __call__(self, wav: np.ndarray, snr_db: Optional[float] = None) -> np.ndarray:
        if self.noise is None:
            return wav
        seg = sample_noise_segment(self.noise, len(wav), self.rng)
        snr = snr_db if snr_db is not None else float(self.rng.choice(SNR_LEVELS))
        return np.asarray(add_noise_snr(wav, seg, snr))


def _whisper_log_mel_core(wav: np.ndarray, n_mels: int) -> np.ndarray:
    """The STFT, mel and log-normalize math of the two Whisper extractors
    (a global max - 8 clamp, + 4, / 4)."""
    n_fft, hop = stft_ops.WHISPER_N_FFT, stft_ops.WHISPER_HOP
    x = np.pad(wav.astype(np.float32), (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx]
    basis = stft_ops._dft_basis(n_fft, n_fft)
    proj = frames @ basis
    n_bins = n_fft // 2 + 1
    mag2 = proj[:, :n_bins] ** 2 + proj[:, n_bins:] ** 2
    mag2 = mag2[:-1]  # Whisper drops the trailing frame
    fb = stft_ops.mel_filterbank(stft_ops.WHISPER_SR, n_fft, n_mels)
    mel = mag2 @ fb
    log_spec = np.log10(np.clip(mel, 1e-10, None))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return np.ascontiguousarray(log_spec.T.astype(np.float32))


def whisper_features_np(wav: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """[T] float32 -> [80, 3000] Whisper log-mel of the clip cut or padded
    to 30 s."""
    n = stft_ops.WHISPER_N_SAMPLES
    if len(wav) >= n:
        wav = wav[:n]
    else:
        wav = np.pad(wav, (0, n - len(wav)))
    return _whisper_log_mel_core(wav, n_mels)


def whisper_features_long_np(wav: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """[T] float32 -> [80, T // 160] Whisper log-mel over the whole clip,
    for ``AVSRSystem.generate_long_form``: the same math without the 30 s
    cut, normalized over the whole clip."""
    wav = np.asarray(wav, np.float32)
    n_fft = stft_ops.WHISPER_N_FFT
    if len(wav) < n_fft:
        wav = np.pad(wav, (0, n_fft - len(wav)))
    return _whisper_log_mel_core(wav, n_mels)


def hifigan_mel_np(wav: np.ndarray) -> np.ndarray:
    """[T] -> [T // 160, 128] natural-log mel targets."""
    n_fft, hop, n_mels = 1024, 160, 128
    pad = (n_fft - hop) // 2
    x = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx]
    basis = stft_ops._dft_basis(n_fft, n_fft)
    proj = frames @ basis
    n_bins = n_fft // 2 + 1
    mag2 = proj[:, :n_bins] ** 2 + proj[:, n_bins:] ** 2
    fb = stft_ops.mel_filterbank(16000, n_fft, n_mels, 0.0, 8000.0)
    mel = mag2 @ fb
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def htk_logmel_np(wav: np.ndarray, sample_rate: int = 16000, n_mels: int = 26,
                  n_fft: int = 400, hop: int = 160) -> np.ndarray:
    """[T] -> [1 + T // hop, n_mels] HTK log mel bands (from 20 Hz, over a
    reflect-padded Hann-windowed STFT, natural log floored at 1e-10): the
    front of AV-HuBERT's filterbanks and of the k-means MFCCs."""
    x = np.pad(wav.astype(np.float32), (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * stft_ops.hann_window(n_fft)
    basis = stft_ops._dft_basis(n_fft, n_fft)
    proj = frames @ basis
    n_bins = n_fft // 2 + 1
    power = proj[:, :n_bins] ** 2 + proj[:, n_bins:] ** 2
    fb = stft_ops.mel_filterbank(sample_rate, n_fft, n_mels, fmin=20.0, fmax=sample_rate / 2,
                                 htk=True)
    return np.log(np.maximum(power @ fb, 1e-10))


def stacked_logfbank_np(wav: np.ndarray, n_mels: int = 26, stack: int = 4) -> np.ndarray:
    """[T] -> [T_frames // stack, n_mels * stack] log filterbank at 25 Hz:
    AV-HuBERT's audio input (26 HTK mel bands over a 400-point STFT, hop
    160, 4 frames stacked to the video rate)."""
    logmel = htk_logmel_np(wav, n_mels=n_mels)  # 25 ms / 10 ms at 16 kHz
    t = (len(logmel) // stack) * stack
    return logmel[:t].reshape(-1, stack * n_mels).astype(np.float32)
