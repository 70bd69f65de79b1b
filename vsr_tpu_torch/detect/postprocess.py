"""DBPostProcess: probability map -> text quads, on the host (copy of
``vsr_tpu/detect/postprocess.py``).

Parameter parity with the reference config (backend/models/V5/ch_det/
inference.yml:48-53): thresh=0.3, box_thresh=0.6, max_candidates=1000,
unclip_ratio=1.5.

Standard DB decoding: binarize at ``thresh``, find contours, take each
contour's min-area rectangle, score it by the mean probability inside the
box, reject below ``box_thresh``, then "unclip" (dilate) the box by
d = area * unclip_ratio / perimeter.

The canonical implementation offsets the polygon with pyclipper; that wheel
isn't available here, so the unclip expands the min-area rectangle by d along
its own axes — exact for rectangles (subtitle boxes are rectangles to within
a pixel) and a tight approximation otherwise.
"""

from __future__ import annotations

from typing import List, Tuple

import cv2
import numpy as np


def _unclip_rect(rect, distance: float):
    (cx, cy), (rw, rh), angle = rect
    return ((cx, cy), (rw + 2.0 * distance, rh + 2.0 * distance), angle)


def _box_score(prob_map: np.ndarray, box: np.ndarray) -> float:
    h, w = prob_map.shape
    xmin = int(np.clip(np.floor(box[:, 0].min()), 0, w - 1))
    xmax = int(np.clip(np.ceil(box[:, 0].max()), 0, w - 1))
    ymin = int(np.clip(np.floor(box[:, 1].min()), 0, h - 1))
    ymax = int(np.clip(np.ceil(box[:, 1].max()), 0, h - 1))
    mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), np.uint8)
    shifted = (box - np.array([xmin, ymin])).round().astype(np.int32)
    cv2.fillPoly(mask, [shifted], 1)
    region = prob_map[ymin : ymax + 1, xmin : xmax + 1]
    if mask.sum() == 0:
        return 0.0
    return float(cv2.mean(region, mask)[0])


def db_postprocess(
    prob_map: np.ndarray,
    dest_hw: Tuple[int, int],
    thresh: float = 0.3,
    box_thresh: float = 0.6,
    max_candidates: int = 1000,
    unclip_ratio: float = 1.5,
    min_size: int = 3,
) -> List[np.ndarray]:
    """prob_map [H, W] float in [0,1] -> list of 4x2 quads in dest (h, w) coords."""
    prob_map = np.asarray(prob_map, np.float32)
    if prob_map.ndim == 3:
        prob_map = prob_map[..., 0]
    h, w = prob_map.shape
    dest_h, dest_w = dest_hw
    bitmap = (prob_map > thresh).astype(np.uint8)
    contours, _ = cv2.findContours(bitmap, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)

    boxes: List[np.ndarray] = []
    for contour in contours[:max_candidates]:
        rect = cv2.minAreaRect(contour)
        if min(rect[1]) < min_size:
            continue
        box = cv2.boxPoints(rect)
        if _box_score(prob_map, box) < box_thresh:
            continue
        rw, rh = rect[1]
        area, perimeter = rw * rh, 2.0 * (rw + rh)
        if perimeter <= 0:
            continue
        distance = area * unclip_ratio / perimeter
        expanded = cv2.boxPoints(_unclip_rect(rect, distance))
        if min(_unclip_rect(rect, distance)[1]) < min_size + 2:
            continue
        expanded[:, 0] = np.clip(expanded[:, 0] / w * dest_w, 0, dest_w)
        expanded[:, 1] = np.clip(expanded[:, 1] / h * dest_h, 0, dest_h)
        boxes.append(expanded.astype(np.float32))
    return boxes
