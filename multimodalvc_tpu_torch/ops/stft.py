"""STFT and log-mel front ends.

Port of ``multimodalvc_tpu/ops/stft.py``: one spectrogram engine serves
Whisper's 80-bin log-mel input features (n_fft 400, hop 160, center reflect
pad, log10 with a max - 8 floor, (x + 4) / 4) and HiFi-GAN's 128-band
natural-log mel targets (n_fft 1024, hop 160, an explicit (n_fft - hop) / 2
reflect pad, power 2, slaney, ln clamp 1e-5).

The STFT is the windowed-DFT matmul of the JAX package, frames [N, n_fft]
@ basis [n_fft, 2 * n_bins], and the mel projection a second matmul: both
differentiable, which the GAN losses need.  Frames are f32, and both
products run at full f32 precision (the JAX ``Precision.HIGHEST``): on the
card cuBLAS takes no TF32 for them, forward or backward, whatever the
caller's setting (``exact_matmul``).  The window, the filterbank and the
basis are numpy, copied from the JAX module.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return w[:win_length].astype(np.float32)


def hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)


def mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """librosa-compatible triangular mel filterbank, [n_bins, n_mels]."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(np.array(fmin), htk), hz_to_mel(np.array(fmax), htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm.reshape(-1, 1)
    return weights.T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis [n_fft, 2 * n_bins]: (real | imag) parts."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    angle = -2.0 * np.pi * t * k / n_fft
    window = np.zeros(n_fft, dtype=np.float64)
    off = (n_fft - win_length) // 2
    window[off: off + win_length] = hann_window(win_length)
    basis = np.concatenate([np.cos(angle), np.sin(angle)], axis=1) * window.reshape(-1, 1)
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _constant(kind: str, args: tuple, device: torch.device) -> torch.Tensor:
    """The basis or the filterbank as an f32 tensor on ``device``, built once."""
    table = _dft_basis(*args) if kind == "basis" else mel_filterbank(*args)
    return torch.from_numpy(table).to(device)


@contextlib.contextmanager
def _no_tf32():
    """cuBLAS at full f32 precision inside the block; the caller's setting
    is put back after it."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = before


class _ExactMatmul(torch.autograd.Function):
    """x @ w without TF32, forward and backward; w is a constant."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        with _no_tf32():
            return x @ w

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        with _no_tf32():
            return g @ w.T, None


def exact_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] at full f32 precision (the JAX
    ``Precision.HIGHEST`` einsum), differentiable in x."""
    return _ExactMatmul.apply(x, w)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., n_frames, n_fft], n_frames = 1 + (T - n_fft) // hop."""
    return x.unfold(-1, n_fft, hop)


def _pad_last(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    shape = x.shape
    return F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode=mode).reshape(*shape[:-1], -1)


def spectrogram(x: torch.Tensor, n_fft: int, hop: int, win_length: Optional[int] = None,
                power: float = 2.0, center: bool = False, pad: int = 0,
                pad_mode: str = "reflect") -> torch.Tensor:
    """Magnitude / power spectrogram, [..., T] -> [..., n_frames, n_bins].
    ``pad`` pads both ends first (HiFi-GAN's (n_fft - hop) / 2), then
    ``center`` pads n_fft / 2 more (torch / librosa semantics)."""
    win_length = win_length or n_fft
    x = x.float()
    if pad > 0:
        x = _pad_last(x, pad, pad_mode)
    if center:
        x = _pad_last(x, n_fft // 2, pad_mode)
    frames = frame_signal(x, n_fft, hop)
    proj = exact_matmul(frames, _constant("basis", (n_fft, win_length), x.device))
    n_bins = n_fft // 2 + 1
    re, im = proj[..., :n_bins], proj[..., n_bins:]
    mag_sq = re * re + im * im
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(torch.clamp(mag_sq, min=1e-20))
    return torch.pow(torch.clamp(mag_sq, min=1e-20), power / 2.0)


def hifigan_log_mel(wav: torch.Tensor, sr: int = 16000, n_fft: int = 1024, hop: int = 160,
                    win_length: int = 1024, n_mels: int = 128, fmin: float = 0.0,
                    fmax: float = 8000.0, norm: Optional[str] = "slaney") -> torch.Tensor:
    """128-band 100 Hz natural-log mel, [..., T] -> [..., n_frames, n_mels]
    (time-major, as the saved mel targets)."""
    spec = spectrogram(wav, n_fft, hop, win_length, power=2.0, pad=(n_fft - hop) // 2)
    fb = _constant("filterbank", (sr, n_fft, n_mels, fmin, fmax, False, norm), spec.device)
    return torch.log(torch.clamp(exact_matmul(spec, fb), min=1e-5))


WHISPER_SR = 16000
WHISPER_N_FFT = 400
WHISPER_HOP = 160
WHISPER_N_MELS = 80
WHISPER_CHUNK_SECONDS = 30
WHISPER_N_SAMPLES = WHISPER_SR * WHISPER_CHUNK_SECONDS  # 480000
WHISPER_N_FRAMES = WHISPER_N_SAMPLES // WHISPER_HOP  # 3000


def whisper_log_mel(wav: torch.Tensor, n_mels: int = WHISPER_N_MELS) -> torch.Tensor:
    """Whisper input features, [..., 480000] -> [..., 80, 3000]: hann
    window, center reflect pad, the power spectrum without its last frame,
    slaney mel, log10 with a per-sample (max - 8) floor, then (x + 4) / 4.
    The caller pads or cuts to 30 s (``pad_to_whisper_chunk``)."""
    spec = spectrogram(wav, WHISPER_N_FFT, WHISPER_HOP, power=2.0, center=True)[..., :-1, :]
    fb = _constant("filterbank", (WHISPER_SR, WHISPER_N_FFT, n_mels, 0.0, None, False, "slaney"),
                   spec.device)
    log_spec = torch.log10(torch.clamp(exact_matmul(spec, fb), min=1e-10))
    maxval = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = (torch.maximum(log_spec, maxval - 8.0) + 4.0) / 4.0
    return log_spec.transpose(-1, -2)


def pad_to_whisper_chunk(wav: torch.Tensor) -> torch.Tensor:
    """Zero-pad or cut the last axis to exactly 30 s (480000 samples)."""
    t = wav.shape[-1]
    if t >= WHISPER_N_SAMPLES:
        return wav[..., :WHISPER_N_SAMPLES]
    return F.pad(wav, (0, WHISPER_N_SAMPLES - t))


def mel_frame_count(n_samples: int, n_fft: int = 1024, hop: int = 160) -> int:
    """Frames ``hifigan_log_mel`` gives an n_samples waveform: floor((L + 2
    pad - n_fft) / hop) + 1 with pad (n_fft - hop) / 2, floor(L / hop) at
    these values."""
    pad = (n_fft - hop) // 2
    return (n_samples + 2 * pad - n_fft) // hop + 1
