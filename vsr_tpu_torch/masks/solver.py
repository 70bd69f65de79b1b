"""Inpaint-band solver: mask -> full-width horizontal bands of fixed height
(copy of ``vsr_tpu/masks/solver.py``).

Behavioural parity with ``get_inpaint_area_by_mask``
(backend/tools/inpaint_tools.py:49-242): connected components of the mask are
grouped vertically (merging islands whose combined vertical span fits in the
band height and that have mask pixels bridging them), then each group is
covered by one band of *exactly* height ``h`` centred on the group, clamped to
the image. With ``multiple`` > 1 (ProPainter, whose networks want sides
divisible by 8) each band is then rounded to that multiple.

Connected-component labelling is done with cv2 on the host — masks are small
and this runs once per chunk, far off the hot path.
"""

from __future__ import annotations

from typing import List, Tuple

import cv2
import numpy as np

Band = Tuple[int, int, int, int]  # (ymin, ymax, xmin, xmax)

_MIN_ISLAND_AREA = 10  # components smaller than this are noise (ref :89)


def _island_stats(binary_mask: np.ndarray) -> List[Tuple[int, int, int]]:
    """Return (top_y, bottom_y, center_y) per connected component, sorted by
    center_y, skipping sub-threshold specks."""
    num_labels, _, stats, centroids = cv2.connectedComponentsWithStats(
        binary_mask, connectivity=8
    )
    islands = []
    for i in range(1, num_labels):
        if stats[i, cv2.CC_STAT_AREA] < _MIN_ISLAND_AREA:
            continue
        top = int(stats[i, cv2.CC_STAT_TOP])
        bottom = top + int(stats[i, cv2.CC_STAT_HEIGHT])
        islands.append((top, bottom, int(centroids[i][1])))
    islands.sort(key=lambda isl: isl[2])
    return islands


def _group_islands(
    islands: List[Tuple[int, int, int]], h: int, binary_mask: np.ndarray
) -> List[List[Tuple[int, int, int]]]:
    """Greedy vertical grouping: absorb the next island when the merged span
    still fits in ``h`` and mask pixels connect the group to it."""
    groups: List[List[Tuple[int, int, int]]] = []
    current = [islands[0]]
    for isl in islands[1:]:
        min_y = min(i[0] for i in current)
        max_y = max(i[1] for i in current)
        top, bottom, _ = isl
        spans_ok = max(max_y, bottom) - min(min_y, top) <= h
        if max_y < top:
            connected = bool(np.any(binary_mask[max_y:top, :] > 0))
        else:
            connected = True
        if spans_ok and connected:
            current.append(isl)
        else:
            groups.append(current)
            current = [isl]
    groups.append(current)
    return groups


def _fit_band(min_y: int, max_y: int, center_y: int, h: int, H: int) -> Tuple[int, int]:
    """Place a band of exactly height ``h`` covering [min_y, max_y] as well as
    possible, centred on ``center_y`` and clamped to [0, H]."""
    half = h // 2
    ymin = max(0, center_y - half)
    ymax = ymin + h
    if ymax > H:
        ymax = H
        ymin = max(0, H - h)
    if ymin > min_y or ymax < max_y:
        if max_y - min_y <= h:
            # band can contain all islands: snap to their top
            ymin = min_y
            ymax = ymin + h
            if ymax > H:
                ymax = H
                ymin = max(0, H - h)
        else:
            # islands taller than the band: centre on the island span
            island_center = (min_y + max_y) // 2
            ymin = max(0, island_center - half)
            ymax = ymin + h
            if ymax > H:
                ymax = H
                ymin = max(0, H - h)
    return ymin, ymax


def _round_to_multiple(
    ymin: int, ymax: int, xmin: int, xmax: int, multiple: int, H: int
) -> Band:
    """Adjust band height/width to a multiple: symmetric growth first, then
    symmetric shrink, then one-sided growth/shrink. (ref :189-235)"""
    height = ymax - ymin
    rem = height % multiple
    if rem != 0:
        grow = multiple - rem
        cy = (ymin + ymax) / 2
        if ymin - grow / 2 >= 0 and ymax + grow / 2 <= H:
            ymin = int(cy - height / 2 - grow / 2)
            ymax = int(cy + height / 2 + grow / 2)
        elif height > multiple:
            ymin = int(cy - (height - rem) / 2)
            ymax = int(cy + (height - rem) / 2)
        else:
            if ymax + grow <= H:
                ymax += grow
            elif ymin - grow >= 0:
                ymin -= grow
            elif height > multiple:
                ymax = ymin + height - rem
    width = xmax - xmin
    rem_w = width % multiple
    if rem_w != 0:
        cx = (xmin + xmax) / 2
        xmin = int(cx - (width - rem_w) / 2)
        xmax = int(cx + (width - rem_w) / 2)
    return int(ymin), int(ymax), int(xmin), int(xmax)


def get_inpaint_area_by_mask(
    W: int, H: int, h: int, mask: np.ndarray, multiple: int = 1
) -> List[Band]:
    """Solve for the minimal set of full-width bands of height ``h`` covering
    the mask. Returns [(ymin, ymax, xmin, xmax), ...]; empty for a blank mask.
    """
    if not np.any(mask):
        return []
    binary_mask = (np.asarray(mask) > 0).astype(np.uint8) * 255
    if binary_mask.ndim == 3:
        binary_mask = binary_mask[:, :, 0]
    islands = _island_stats(binary_mask)
    if not islands:
        return []

    bands: List[Band] = []
    for group in _group_islands(islands, h, binary_mask):
        min_y = min(i[0] for i in group)
        max_y = max(i[1] for i in group)
        center_y = sum(i[2] for i in group) // len(group)
        ymin, ymax = _fit_band(min_y, max_y, center_y, h, H)
        if multiple > 1:
            band = _round_to_multiple(ymin, ymax, 0, W, multiple, H)
        else:
            band = (int(ymin), int(ymax), 0, int(W))
        if band not in bands:
            bands.append(band)
    return bands
