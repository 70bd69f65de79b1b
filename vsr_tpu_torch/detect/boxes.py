"""Detected-quad decoding (copy of ``vsr_tpu/detect/boxes.py``; parity with
backend/tools/ocr.py:1-20)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

Box = Tuple[int, int, int, int]  # (xmin, xmax, ymin, ymax)


def get_coordinates(dt_polys: Sequence[Sequence[Sequence[float]]]) -> List[Box]:
    """Quadrilateral corner lists -> axis-aligned (xmin, xmax, ymin, ymax)."""
    coordinate_list: List[Box] = []
    for poly in dt_polys:
        xs = [p[0] for p in poly]
        ys = [p[1] for p in poly]
        coordinate_list.append(
            (int(min(xs)), int(max(xs)), int(min(ys)), int(max(ys)))
        )
    return coordinate_list
