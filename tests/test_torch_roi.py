"""The port's mouth-ROI module (data/roi.py) against the JAX one on the same
inputs: the Umeyama similarity, the dropout interpolation, the crop of a
whole clip, the default mean face, and the gated detector's error."""
import numpy as np
import pytest

from multimodalvc_tpu.data import roi as jroi
from multimodalvc_tpu_torch.data import roi as troi


def test_umeyama_matches_jax_and_recovers_the_similarity():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((10, 2)) * 20
    theta, scale, shift = 0.3, 1.7, np.asarray([5.0, -3.0])
    rot = scale * np.asarray([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    dst = src @ rot.T + shift
    m = troi.umeyama_similarity(src, dst)
    np.testing.assert_array_equal(m, jroi.umeyama_similarity(src, dst))
    ones = np.concatenate([src, np.ones((10, 1))], axis=1)
    np.testing.assert_allclose(ones @ m.T, dst, atol=1e-3)


def test_interpolation_matches_jax():
    rng = np.random.default_rng(1)
    marks = [None, rng.standard_normal((68, 2)).astype(np.float32), None, None,
             rng.standard_normal((68, 2)).astype(np.float32), None]
    got, want = troi.landmarks_interpolate(marks), jroi.landmarks_interpolate(marks)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2], marks[1] + (marks[4] - marks[1]) / 3, rtol=1e-6)
    assert troi.landmarks_interpolate([None, None]) is None


def test_crop_matches_jax():
    """A clip with a bright mouth square: the same ROIs as the JAX module's,
    the square near each crop's centre."""
    np.testing.assert_array_equal(troi.default_mean_face(200), jroi.default_mean_face(200))
    face = troi.default_mean_face(256)
    lms = (face * 0.5 + 16.0).astype(np.float32)
    frames = np.zeros((4, 160, 160), np.float32)
    mx, my = (int(v) for v in lms[48:68].mean(axis=0))
    frames[:, my - 6:my + 6, mx - 6:mx + 6] = 1.0
    marks = [lms + 0.25 * i for i in range(4)]
    marks[1] = None
    kw = dict(std_size=256, crop_height=24, crop_width=24)
    got = troi.crop_mouth_rois(frames, marks, face, **kw)
    np.testing.assert_array_equal(got, jroi.crop_mouth_rois(frames, marks, face, **kw))
    assert got.shape == (4, 48, 48)
    for r in got:
        ys, xs = np.where(r > 0.5)
        assert abs(ys.mean() - 24) < 8 and abs(xs.mean() - 24) < 8


def test_detector_gated_with_the_jax_error():
    try:
        import mediapipe  # noqa: F401
        pytest.skip("a detector backend is importable here")
    except ImportError:
        pass
    try:
        import dlib  # noqa: F401
        pytest.skip("a detector backend is importable here")
    except ImportError:
        pass
    frames = np.zeros((2, 32, 32), np.uint8)
    with pytest.raises(RuntimeError) as want:
        jroi.detect_landmarks(frames)
    with pytest.raises(RuntimeError, match="--landmarks") as got:
        troi.detect_landmarks(frames)
    assert str(got.value) == str(want.value)
    assert troi.MEDIAPIPE_IBUG68 == jroi.MEDIAPIPE_IBUG68
