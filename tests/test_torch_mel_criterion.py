"""The port's mel criterion against the JAX package's
(``criterions/mel.py``) on seeded [B, T, 128] log-mels in f32: the masked
L1 (rows of every length, an empty one too), the MCD, the SSIM and
``MelL1Criterion`` at training and at validation, with a prediction longer
than its target and lengths that disagree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import t

from multimodalvc_tpu.criterions import mel as jmel
from multimodalvc_tpu_torch.criterions import mel as tmel

# f32 reductions of a few thousand terms in other orders: rel 1e-5 (the MCD,
# a mean of square roots, and the SSIM, a mean of ratios of 11x11 window
# sums, as well)
RTOL = 1e-5


def mels(b=3, t_pred=40, t_tgt=36, d=128, seed=0):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((b, t_pred, d)).astype(np.float32)
    target = (pred[:, :t_tgt] + 0.3 * rng.standard_normal((b, t_tgt, d))).astype(np.float32)
    return pred, target


def test_dct_matrix_equals_jax():
    np.testing.assert_array_equal(tmel.dct_matrix(13, 128), jmel.dct_matrix(13, 128))
    np.testing.assert_array_equal(tmel._gauss_kernel(11), jmel._gauss_kernel(11))


@pytest.mark.parametrize("lengths", [[40, 17, 1], [0, 0, 0], [40, 40, 40]])
def test_masked_l1_matches_jax(lengths):
    pred, _ = mels()
    target, _ = mels(seed=1)
    lens = np.asarray(lengths, np.int32)
    want = float(jmel.masked_l1(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(lens)))
    got = float(tmel.masked_l1(t(pred), t(target), t(lens)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if not any(lengths):
        assert got == 0.0  # the denominator is floored at 1


def test_mcd_and_ssim_match_jax():
    pred, target = mels(t_pred=36)
    lens = np.asarray([36, 20, 5], np.int32)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    for want, got in [
        (jmel.compute_mcd(jp, jt, jnp.asarray(lens)), tmel.compute_mcd(t(pred), t(target), t(lens))),
        (jmel.compute_mcd(jp, jt), tmel.compute_mcd(t(pred), t(target))),
        (jmel.compute_ssim(jp, jt), tmel.compute_ssim(t(pred), t(target))),
        (jmel.compute_ssim(jp, jp), tmel.compute_ssim(t(pred), t(pred))),
    ]:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    assert float(tmel.compute_ssim(t(pred), t(pred))) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_criterion_matches_jax(train):
    pred, target = mels()
    out = {"melspec": pred, "mel_lengths": np.asarray([40, 30, 12], np.int32)}
    batch = {"target_mel": target, "target_mel_lengths": np.asarray([36, 33, 20], np.int32)}
    _, want = jmel.MelL1Criterion(jmel.MelL1Config())(
        {k: jnp.asarray(v) for k, v in out.items()}, {k: jnp.asarray(v) for k, v in batch.items()},
        train=train)
    loss, got = tmel.MelL1Criterion(tmel.MelL1Config())(
        {k: t(v) for k, v in out.items()}, {k: t(v) for k, v in batch.items()}, train=train)
    assert set(got) == set(want) == ({"loss", "mel_l1"} | (set() if train else {"mcd", "ssim"}))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)
    assert loss is got["loss"]
    # the loss is the masked L1 over min(lengths) frames, cut to the target
    manual = tmel.masked_l1(t(pred[:, :36]), t(target), torch.tensor([36, 30, 12]))
    assert float(loss) == float(manual)


def test_criterion_reports_what_its_config_asks():
    pred, target = mels()
    out = {"melspec": t(pred), "mel_lengths": torch.tensor([40, 30, 12])}
    batch = {"target_mel": t(target), "target_mel_lengths": torch.tensor([36, 33, 20])}
    _, metrics = tmel.MelL1Criterion(tmel.MelL1Config(report_mcd=False))(out, batch, train=False)
    assert set(metrics) == {"loss", "mel_l1", "ssim"}
    # a bf16 prediction is scored in f32
    loss, _ = tmel.MelL1Criterion()({**out, "melspec": out["melspec"].bfloat16()}, batch)
    assert loss.dtype == torch.float32
