"""OpenCV Telea inpainting mode (copy of ``vsr_tpu/inpaint/opencv.py``).

Parity with backend/inpaint/opencv_inpaint.py:3-15: per-frame
``cv2.inpaint(frame, mask, 3, flags=1)`` — flag value 1 is INPAINT_TELEA
(the reference passes cv2.INTER_LINEAR, which aliases the same value).
Host CPU only; exists as the zero-model-weight fallback mode.
"""

from __future__ import annotations

from typing import List

import cv2
import numpy as np


class OpenCVInpainter:
    def __call__(self, frames: List[np.ndarray], mask: np.ndarray) -> List[np.ndarray]:
        mask_u8 = (np.asarray(mask) > 0).astype(np.uint8)
        if mask_u8.ndim == 3:
            mask_u8 = mask_u8[:, :, 0]
        return [cv2.inpaint(f, mask_u8, 3, cv2.INPAINT_TELEA) for f in frames]

    def inpaint(self, frame: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return self([frame], mask)[0]
