"""The port's STFT and log-mel front ends against the JAX package's
(``ops/stft.py``), on seeded waveforms in f32: the filterbank and the window
exactly, the spectrogram in each of its modes, HiFi-GAN's and Whisper's
log-mels, and the gradient of a mel L1 with respect to the waveform."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import max_err, t

from multimodalvc_tpu.ops import stft as jstft
from multimodalvc_tpu_torch.ops import stft as tstft

# Both sides are the same two f32 matmuls summed in other orders: the power
# spectrogram agrees to 1e-5 of its largest value; the natural-log mel to
# 2e-5 absolute where the power is far above the 1e-5 clamp (a random
# waveform at 0.1 leaves every band there); Whisper's log10 features, after
# the (x + 4) / 4 scaling, to 1e-5; the gradient of the mel L1 to 1e-4 of
# its largest value
SPEC_RTOL, LOGMEL_ATOL, WHISPER_ATOL, GRAD_RTOL = 1e-5, 2e-5, 1e-5, 1e-4


def waveform(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_tables_equal_jax():
    for args in [(16000, 1024, 128, 0.0, 8000.0), (16000, 400, 80), (22050, 512, 64, 20.0)]:
        np.testing.assert_array_equal(tstft.mel_filterbank(*args), jstft.mel_filterbank(*args))
    np.testing.assert_array_equal(tstft.mel_filterbank(16000, 512, 40, htk=True, norm=None),
                                  jstft.mel_filterbank(16000, 512, 40, htk=True, norm=None))
    for n in (400, 1024):
        np.testing.assert_array_equal(tstft.hann_window(n), jstft.hann_window(n))
        np.testing.assert_array_equal(tstft._dft_basis(n, n), jstft._dft_basis(n, n))
    np.testing.assert_array_equal(tstft._dft_basis(512, 400), jstft._dft_basis(512, 400))


@pytest.mark.parametrize("kw", [
    dict(n_fft=1024, hop=160, pad=432),
    dict(n_fft=400, hop=160, center=True),
    dict(n_fft=512, hop=128, win_length=400, power=1.0),
    dict(n_fft=256, hop=64, power=3.0, center=True, pad=10),
])
def test_spectrogram_matches_jax(kw):
    x = waveform((2, 3, 2000), seed=1)
    want = np.asarray(jstft.spectrogram(jnp.asarray(x), **kw))
    got = tstft.spectrogram(t(x), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert max_err(want, got) <= SPEC_RTOL * np.abs(want).max()


def test_hifigan_log_mel_matches_jax():
    x = waveform((3, 8320), seed=2)
    want = np.asarray(jstft.hifigan_log_mel(jnp.asarray(x)))
    got = tstft.hifigan_log_mel(t(x))
    assert got.shape == want.shape == (3, 52, 128)
    assert max_err(want, got) < LOGMEL_ATOL
    # the frame count, here and at lengths off the hop
    for n in (16000, 12345, 8320, 1024):
        assert tstft.mel_frame_count(n) == jstft.mel_frame_count(n) == n // 160
        assert tstft.hifigan_log_mel(torch.zeros(n)).shape == (n // 160, 128)
    # silence sits at the clamp
    assert torch.equal(tstft.hifigan_log_mel(torch.zeros(1600)),
                       torch.full((10, 128), float(np.log(np.float32(1e-5)))))


def test_whisper_log_mel_matches_jax():
    x = waveform(40000, seed=3)
    want = np.asarray(jstft.whisper_log_mel(jstft.pad_to_whisper_chunk(jnp.asarray(x))))
    padded = tstft.pad_to_whisper_chunk(t(x))
    assert padded.shape == (480000,) and torch.equal(padded[:40000], t(x))
    assert not bool(padded[40000:].any())
    got = tstft.whisper_log_mel(padded)
    assert got.shape == want.shape == (80, 3000)
    assert max_err(want, got) < WHISPER_ATOL
    # a longer clip is cut to 30 s
    assert tstft.pad_to_whisper_chunk(torch.ones(2, 500000)).shape == (2, 480000)


def test_mel_l1_gradient_matches_jax():
    """The generator loss's mel term: d mean|logmel(w) - logmel(gt)| / dw."""
    w, gt = waveform((2, 3200), seed=4), waveform((2, 3200), seed=5)

    def jloss(w):
        return jnp.mean(jnp.abs(jstft.hifigan_log_mel(w) - jstft.hifigan_log_mel(jnp.asarray(gt))))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(w)))
    tw = t(w).requires_grad_()
    loss = (tstft.hifigan_log_mel(tw) - tstft.hifigan_log_mel(t(gt))).abs().mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jnp.asarray(w))), rtol=1e-5)
    assert max_err(want, tw.grad) <= GRAD_RTOL * np.abs(want).max()


def test_exact_matmul_leaves_the_callers_setting():
    """The products turn TF32 off only while they run: the caller's flag is
    back after the forward and after the backward, and the values are the
    plain product's."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    try:
        for setting in (True, False):
            flags.allow_tf32 = setting
            x = torch.randn(4, 8, requires_grad=True)
            w = torch.randn(8, 3)
            y = tstft.exact_matmul(x, w)
            assert flags.allow_tf32 is setting
            y.sum().backward()
            assert flags.allow_tf32 is setting
            torch.testing.assert_close(y, x @ w, rtol=0, atol=0)
            torch.testing.assert_close(x.grad, torch.ones(4, 3) @ w.T, rtol=0, atol=0)
    finally:
        flags.allow_tf32 = before
