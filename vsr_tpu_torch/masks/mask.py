"""Mask construction (copy of ``vsr_tpu/masks/mask.py``; behavioural parity
with backend/tools/inpaint_tools.py:31-47).

Pure numpy — rectangles are filled with array slicing rather than cv2 so this
is trivially testable and has no image-library dependency.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np


def create_mask(
    size: Tuple[int, int],
    coords_list: Iterable[Sequence[int]],
    deviation_pixel: int = 10,
) -> np.ndarray:
    """Rasterize (xmin, xmax, ymin, ymax) boxes into a uint8 mask.

    Each box is dilated by ``deviation_pixel`` on every side (the reference
    grows boxes to avoid leftover text edges, inpaint_tools.py:37-44) and
    filled with 255. ``size`` is (H, W).

    Note the reference draws through ``cv2.rectangle`` whose corner points are
    inclusive, so the filled region is [y1, y2] x [x1, x2] *inclusive*; we
    reproduce that by slicing to y2+1 / x2+1 (clipped to the canvas).
    """
    h, w = size
    mask = np.zeros((h, w), dtype=np.uint8)
    for coords in coords_list or ():
        xmin, xmax, ymin, ymax = coords
        x1 = max(0, int(xmin) - deviation_pixel)
        y1 = max(0, int(ymin) - deviation_pixel)
        x2 = int(xmax) + deviation_pixel
        y2 = int(ymax) + deviation_pixel
        if x2 < 0 or y2 < 0 or x1 >= w or y1 >= h:
            continue
        mask[y1 : min(y2 + 1, h), x1 : min(x2 + 1, w)] = 255
    return mask


def binarize_mask(mask: np.ndarray, thresh: int = 127) -> np.ndarray:
    """uint8 mask -> {0,1} uint8 with a trailing channel axis.

    Mirrors the reference's ``cv2.threshold(mask, 127, 1, THRESH_BINARY)``
    followed by ``[:, :, None]`` (sttn_auto_inpaint.py:48-49).
    """
    binary = (mask > thresh).astype(np.uint8)
    if binary.ndim == 2:
        binary = binary[:, :, None]
    return binary
