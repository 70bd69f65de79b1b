"""Band paste-back: the model-scale row slice a mask covers, and the masked
blend of the inpainted band into the full frame.

Copy of ``vsr_tpu/inpaint/paste.py:23-70``, on the port's own native host
ops (which raise if they cannot be built, rather than falling back to cv2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vsr_tpu_torch import native


def band_out_rows(mask01: np.ndarray, band, model_h: int) -> Tuple[int, int]:
    """Static model-scale row slice covering the mask within this band.

    Only these rows of the composited band cross device->host; the slice
    includes a 2-row margin so every blended pixel's bilinear support is
    inside it (paste-back is exact within the mask)."""
    ymin, ymax, _, _ = band
    band_h = ymax - ymin
    rows = np.nonzero(mask01[ymin:ymax, :, 0].any(axis=1))[0]
    if len(rows) == 0:
        return (0, model_h)
    scale = model_h / band_h
    y0, y1 = int(rows[0]), int(rows[-1]) + 1
    r0 = int(np.floor((y0 + 0.5) * scale - 0.5)) - 2
    r1 = int(np.ceil((y1 - 0.5) * scale - 0.5)) + 3
    return (max(0, r0), min(model_h, r1))


def paste_band(
    frame: np.ndarray,
    comp: np.ndarray,
    band,
    mask01: np.ndarray,
    model_h: int,
    out_rows: Optional[Tuple[int, int]] = None,
) -> None:
    """Blend the inpainted band back: mask*comp + (1-mask)*frame.

    ``comp`` may be just the out_rows slice of the model-height band; it is
    placed back into a full-height buffer (zeros elsewhere — those pixels are
    outside the mask and its interpolation margin, so they are never blended
    in). Uses the fused native resize+blend. Modifies ``frame`` (C-contiguous)
    in place."""
    ymin, ymax, _, _ = band
    band_h = ymax - ymin
    if out_rows is not None and comp.shape[0] != model_h:
        full = np.zeros((model_h, comp.shape[1], 3), np.uint8)
        full[out_rows[0] : out_rows[1]] = comp
        comp = full
    mask_region = np.ascontiguousarray(mask01[ymin:ymax, :, 0])
    native.paste_band_blend(frame, np.ascontiguousarray(comp), mask_region, ymin, band_h)
