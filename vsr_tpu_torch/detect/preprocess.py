"""DBNet preprocessing (copy of ``vsr_tpu/detect/preprocess.py``), matching
the reference inference config
(backend/models/V5/ch_det/inference.yml:22-46): BGR input, resize so the long
side is <= 960 with both dims rounded to multiples of 32, ImageNet
normalization in RGB order... — note Paddle normalizes the BGR array with
RGB-ordered mean/std as-is (no channel swap in the config), which we mirror.
"""

from __future__ import annotations

from typing import Tuple

import cv2
import numpy as np

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def det_resize_shape(h: int, w: int, resize_long: int = 960) -> Tuple[int, int]:
    """Target (H, W): long side scaled to resize_long, both rounded to /32."""
    scale = float(resize_long) / max(h, w)
    rh, rw = int(round(h * scale / 32) * 32), int(round(w * scale / 32) * 32)
    return max(32, rh), max(32, rw)


def preprocess_frame(frame_bgr: np.ndarray, resize_long: int = 960) -> np.ndarray:
    """BGR uint8 HxWx3 -> normalized float32 [H', W', 3] (H', W' /32)."""
    h, w = frame_bgr.shape[:2]
    rh, rw = det_resize_shape(h, w, resize_long)
    resized = cv2.resize(frame_bgr, (rw, rh))
    return (resized.astype(np.float32) / 255.0 - _MEAN) / _STD


def scale_factors(h: int, w: int, resize_long: int = 960) -> Tuple[float, float]:
    """(sy, sx) mapping detector coordinates back to the original frame."""
    rh, rw = det_resize_shape(h, w, resize_long)
    return h / rh, w / rw
