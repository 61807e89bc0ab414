"""Video decode and mouth-ROI transforms (host side, numpy).

Port of ``multimodalvc_tpu/data/video.py``: grayscale decode, then /255 ->
center crop (evaluation) or random crop + horizontal flip (training) ->
(x - mean) / std.  ``.npy`` / ``.npz`` files load without cv2; other
containers need it.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


def load_video_frames(path: str, retries: int = 3) -> np.ndarray:
    """Decode to [T, H, W] grayscale uint8."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
        return np.asarray(arr, dtype=np.uint8)
    if not _HAVE_CV2:
        raise RuntimeError("cv2 unavailable and input is not .npy")
    for attempt in range(retries):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
        cap.release()
        if frames:
            return np.stack(frames)
        logger.warning("video decode retry %d for %s", attempt + 1, path)
    raise RuntimeError(f"failed to decode video {path}")


def center_crop(frames: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    t, h, w = frames.shape[:3]
    ch, cw = size
    y = (h - ch) // 2
    x = (w - cw) // 2
    return frames[:, y : y + ch, x : x + cw]


def random_crop(frames: np.ndarray, size: Tuple[int, int], rng: np.random.Generator) -> np.ndarray:
    t, h, w = frames.shape[:3]
    ch, cw = size
    y = int(rng.integers(0, h - ch + 1))
    x = int(rng.integers(0, w - cw + 1))
    return frames[:, y : y + ch, x : x + cw]


def horizontal_flip(frames: np.ndarray, prob: float, rng: np.random.Generator) -> np.ndarray:
    if rng.random() < prob:
        return frames[:, :, ::-1]
    return frames


def transform_video(
    frames: np.ndarray,
    crop_size: int = 88,
    mean: float = 0.421,
    std: float = 0.165,
    train: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """uint8 [T, H, W] -> float32 [T, crop, crop, 1], normalized with the
    LRS3 lip-reading constants by default."""
    x = frames.astype(np.float32) / 255.0
    if train:
        rng = rng or np.random.default_rng()
        x = random_crop(x, (crop_size, crop_size), rng)
        x = horizontal_flip(x, 0.5, rng)
    else:
        x = center_crop(x, (crop_size, crop_size))
    x = (x - mean) / std
    return np.ascontiguousarray(x)[..., None]
