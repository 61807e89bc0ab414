"""Mouth-ROI extraction: landmark smoothing, mean-face alignment, crop.

Port of ``multimodalvc_tpu/data/roi.py`` (numpy; the JAX package's module
imports no JAX either, and the port keeps its own copy).  Per-frame 68-point
landmarks are interpolated over detector dropouts, smoothed over a window,
registered to a mean face with a similarity (Umeyama) transform, the frame
is warped (cv2 where it is installed, else scipy's ``ndimage``), and a fixed
crop is cut around the mouth points (48:68) (reference:
avhubert/preparation/align_mouth.py:24-254 + detect_landmark.py).

Landmark *detection* needs dlib or mediapipe: ``detect_landmarks`` gates
on their availability, with the JAX module's error, and ``cli.manifest_tools
align-mouth`` takes precomputed landmark files (the reference runs detection
as a separate stage too).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

MOUTH_POINTS = slice(48, 68)
STABLE_POINTS = (33, 36, 39, 42, 45)  # nose tip + eye corners


def landmarks_interpolate(landmarks: Sequence[Optional[np.ndarray]]) -> Optional[List[np.ndarray]]:
    """Fill detector dropouts by linear interpolation between valid frames
    (align_mouth.py:184-205; edges are padded with the nearest valid)."""
    valid = [i for i, lm in enumerate(landmarks) if lm is not None]
    if not valid:
        return None
    out: List[Optional[np.ndarray]] = list(landmarks)
    for a, b in zip(valid[:-1], valid[1:]):
        if b - a <= 1:
            continue
        for j in range(a + 1, b):
            w = (j - a) / (b - a)
            out[j] = (1 - w) * landmarks[a] + w * landmarks[b]
    first, last = valid[0], valid[-1]
    for j in range(first):
        out[j] = landmarks[first]
    for j in range(last + 1, len(landmarks)):
        out[j] = landmarks[last]
    return [np.asarray(lm, np.float32) for lm in out]


def umeyama_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform src->dst (Umeyama'91), returning a
    2x3 matrix (the reference uses skimage.transform.estimate_transform
    ('similarity'), align_mouth.py:33-38)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_s = (sc**2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / var_s
    rot = scale * (u @ diag @ vt)
    t = mu_d - rot @ mu_s
    return np.concatenate([rot, t[:, None]], axis=1).astype(np.float32)  # [2, 3]


def warp_frame(frame: np.ndarray, matrix: np.ndarray, out_size: int) -> np.ndarray:
    """Apply a 2x3 similarity to a [H, W] (or [H, W, C]) frame."""
    try:  # cv2 when present (parity with the reference)
        import cv2

        return cv2.warpAffine(frame, matrix, (out_size, out_size))
    except Exception:
        from scipy import ndimage

        # scipy maps OUTPUT coords -> INPUT coords: invert the transform.
        # landmarks are (x, y) while arrays index (row=y, col=x): swap axes.
        rot, t = matrix[:, :2], matrix[:, 2]
        inv_rot = np.linalg.inv(rot)
        inv_t = -inv_rot @ t
        swap = np.asarray([[0.0, 1.0], [1.0, 0.0]])
        m_rc = swap @ inv_rot @ swap
        off = swap @ inv_t
        if frame.ndim == 2:
            return ndimage.affine_transform(
                frame, m_rc, offset=off, output_shape=(out_size, out_size), order=1
            ).astype(frame.dtype)
        chans = [
            ndimage.affine_transform(
                frame[..., c], m_rc, offset=off, output_shape=(out_size, out_size), order=1
            )
            for c in range(frame.shape[-1])
        ]
        return np.stack(chans, axis=-1).astype(frame.dtype)


def cut_patch(img: np.ndarray, points: np.ndarray, height: int, width: int) -> np.ndarray:
    """Crop around the landmark centroid, clamped to the image
    (align_mouth.py:63-88)."""
    cy, cx = float(np.mean(points[:, 1])), float(np.mean(points[:, 0]))
    h, w = img.shape[:2]
    cy = min(max(cy, height), h - height)
    cx = min(max(cx, width), w - width)
    y0, x0 = int(round(cy - height)), int(round(cx - width))
    return img[y0 : y0 + 2 * height, x0 : x0 + 2 * width]


def crop_mouth_rois(
    frames: np.ndarray,  # [T, H, W] grayscale
    landmarks: Sequence[Optional[np.ndarray]],  # T x [68, 2] (x, y) or None
    mean_face: np.ndarray,  # [68, 2] reference landmarks in std space
    std_size: int = 256,
    window_margin: int = 12,
    crop_height: int = 48,
    crop_width: int = 48,
) -> Optional[np.ndarray]:
    """[T, H, W] -> [T, 2*crop_height, 2*crop_width] mouth ROIs
    (crop_patch flow, align_mouth.py:130-182: sliding-window landmark mean,
    per-frame similarity to the mean face on the stable points, warp, cut)."""
    lms = landmarks_interpolate(landmarks)
    if lms is None:
        return None
    t = len(frames)
    stack = np.stack(lms)  # [T, 68, 2]
    rois = []
    stable = list(STABLE_POINTS)
    for i in range(t):
        lo = max(0, i - window_margin // 2)
        hi = min(t, i + window_margin // 2 + 1)
        smoothed = stack[lo:hi].mean(axis=0)
        # keep the current frame's offset like the reference (:158-161)
        cur = smoothed - smoothed.mean(axis=0) + stack[i].mean(axis=0)
        mat = umeyama_similarity(cur[stable], mean_face[stable])
        warped = warp_frame(frames[i], mat, std_size)
        ones = np.concatenate([cur, np.ones((68, 1), np.float32)], axis=1)
        warped_lm = ones @ mat.T  # [68, 2]
        rois.append(cut_patch(warped, warped_lm[MOUTH_POINTS], crop_height, crop_width))
    return np.stack(rois)


def default_mean_face(std_size: int = 256) -> np.ndarray:
    """Synthetic 68-point mean face for when the reference's
    20words_mean_face.npy artifact is absent: canonical proportions in a
    std_size x std_size frame (detection artifacts supply the real one)."""
    f = std_size / 256.0
    pts = np.zeros((68, 2), np.float32)
    # jaw 0-16: ellipse arc
    ang = np.linspace(np.pi * 0.15, np.pi * 0.85, 17)
    pts[0:17, 0] = 128 + 88 * np.cos(ang[::-1])
    pts[0:17, 1] = 110 + 95 * np.sin(ang[::-1])
    # brows 17-26
    pts[17:22] = np.stack([np.linspace(70, 115, 5), np.full(5, 78.0)], axis=1)
    pts[22:27] = np.stack([np.linspace(141, 186, 5), np.full(5, 78.0)], axis=1)
    # nose 27-35
    pts[27:31] = np.stack([np.full(4, 128.0), np.linspace(95, 135, 4)], axis=1)
    pts[31:36] = np.stack([np.linspace(112, 144, 5), np.full(5, 145.0)], axis=1)
    # eyes 36-47
    for base, cx in ((36, 92.0), (42, 164.0)):
        ang6 = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        pts[base : base + 6, 0] = cx + 14 * np.cos(ang6)
        pts[base : base + 6, 1] = 100 + 7 * np.sin(ang6)
    # mouth 48-67
    ang12 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    pts[48:60, 0] = 128 + 26 * np.cos(ang12)
    pts[48:60, 1] = 180 + 13 * np.sin(ang12)
    ang8 = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts[60:68, 0] = 128 + 14 * np.cos(ang8)
    pts[60:68, 1] = 180 + 7 * np.sin(ang8)
    return pts * f


# MediaPipe FaceMesh (468 points) -> iBUG 68-point scheme.  Standard mapping
# used across open-source ports of the dlib layout; groups: jaw 0-16, brows
# 17-26, nose bridge 27-30, lower nose 31-35, eyes 36-47, outer lip 48-59,
# inner lip 60-67.
MEDIAPIPE_IBUG68 = (
    127, 234, 93, 58, 172, 136, 149, 148, 152, 377, 378, 365, 397, 288, 323, 454, 356,
    70, 63, 105, 66, 107,
    336, 296, 334, 293, 300,
    168, 197, 5, 4,
    75, 97, 2, 326, 305,
    33, 160, 158, 133, 153, 144,
    362, 385, 387, 263, 373, 380,
    61, 39, 37, 0, 267, 269, 291, 405, 314, 17, 84, 181,
    78, 82, 13, 312, 308, 317, 14, 87,
)


def _to_rgb_uint8(frame: np.ndarray) -> np.ndarray:
    f = np.asarray(frame)
    if f.dtype != np.uint8:
        lo, hi = float(f.min()), float(f.max())
        f = ((f - lo) / max(hi - lo, 1e-6) * 255.0).astype(np.uint8) if hi > 1.5 or lo < 0 else (
            (np.clip(f, 0, 1) * 255.0).astype(np.uint8)
        )
    if f.ndim == 2:
        f = np.repeat(f[..., None], 3, axis=-1)
    return np.ascontiguousarray(f)


def _detect_mediapipe(frames: np.ndarray) -> List[Optional[np.ndarray]]:
    """FaceMesh tracking over the clip; 468-point mesh mapped to iBUG-68
    (reference: avhubert/preparation/detect_landmark.py mediapipe branch)."""
    import mediapipe as mp

    idx = np.asarray(MEDIAPIPE_IBUG68, np.int64)
    out: List[Optional[np.ndarray]] = []
    with mp.solutions.face_mesh.FaceMesh(
        static_image_mode=False, max_num_faces=1, refine_landmarks=False,
        min_detection_confidence=0.5, min_tracking_confidence=0.5,
    ) as mesh:
        for frame in frames:
            rgb = _to_rgb_uint8(frame)
            h, w = rgb.shape[:2]
            res = mesh.process(rgb)
            if not res.multi_face_landmarks:
                out.append(None)
                continue
            pts = res.multi_face_landmarks[0].landmark
            xy = np.asarray([[p.x * w, p.y * h] for p in pts], np.float32)
            out.append(xy[idx])
    return out


def _detect_dlib(
    frames: np.ndarray, predictor_path: Optional[str] = None
) -> List[Optional[np.ndarray]]:
    """dlib HOG face detector + 68-point shape predictor (reference:
    detect_landmark.py dlib branch; the predictor .dat ships separately —
    pass its path or set MMVC_DLIB_PREDICTOR)."""
    import os

    import dlib

    predictor_path = predictor_path or os.environ.get("MMVC_DLIB_PREDICTOR")
    if not predictor_path or not os.path.exists(predictor_path):
        raise RuntimeError(
            "dlib backend needs the 68-point shape predictor model: pass "
            "predictor_path or set MMVC_DLIB_PREDICTOR to "
            "shape_predictor_68_face_landmarks.dat"
        )
    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)
    out: List[Optional[np.ndarray]] = []
    for frame in frames:
        img = _to_rgb_uint8(frame)
        rects = detector(img, 1)
        if not rects:
            out.append(None)
            continue
        rect = max(rects, key=lambda r: r.width() * r.height())
        shape = predictor(img, rect)
        out.append(
            np.asarray([[shape.part(i).x, shape.part(i).y] for i in range(68)], np.float32)
        )
    return out


def detect_landmarks(
    frames: np.ndarray,
    backend: Optional[str] = None,
    predictor_path: Optional[str] = None,
) -> List[Optional[np.ndarray]]:
    """68-point landmark detection (detect_landmark.py analog).

    frames: [T, H, W] grayscale or [T, H, W, 3] RGB.  Returns a length-T list
    of [68, 2] (x, y) arrays, None where no face was found (interpolated
    downstream by landmarks_interpolate).  Tries mediapipe, then dlib; raises
    with guidance when neither is importable so pipelines fall back to
    precomputed landmark files.
    """
    order = (backend,) if backend else ("mediapipe", "dlib")
    errors = []
    for b in order:
        if b == "mediapipe":
            try:
                import mediapipe  # noqa: F401
            except ImportError as e:
                errors.append(f"mediapipe: {e}")
                continue
            return _detect_mediapipe(frames)
        if b == "dlib":
            try:
                import dlib  # noqa: F401
            except ImportError as e:
                errors.append(f"dlib: {e}")
                continue
            return _detect_dlib(frames, predictor_path)
        errors.append(f"unknown backend {b!r}")
    raise RuntimeError(
        "landmark detection needs dlib or mediapipe ("
        + "; ".join(errors)
        + "); run the detection stage elsewhere and pass --landmarks "
        "<file.npy> (T x 68 x 2) to align-mouth"
    )
