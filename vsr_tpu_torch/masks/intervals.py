"""Frame-interval algebra (copied from ``vsr_tpu/masks/intervals.py``).

Behavioural parity with the pure-function half of the reference's
``backend/tools/inpaint_tools.py`` (batch_generator:7-29,
expand_frame_ranges:244-301, is_frame_number_in_ab_sections:303-321) and the
static helpers of ``backend/tools/subtitle_detect.py`` (unify_regions:181-215,
find_continuous_ranges:218-235, find_continuous_ranges_with_same_mask:238-258,
filter_and_merge_intervals:260-293). All functions are pure and host-side.
``split_range_by_scene`` comes with ProPainter mode.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

Range = Tuple[int, int]


def batch_generator(data: Sequence, max_batch_size: int) -> Iterator[Sequence]:
    """Yield near-uniform batches of at most ``max_batch_size`` items.

    The batch size is lowered until the trailing remainder is at least half a
    batch (or batch_size hits 1), which keeps batch sizes balanced — same
    policy as the reference (inpaint_tools.py:7-29).
    """
    n = len(data)
    batch_size = max(1, int(max_batch_size))
    while batch_size > 1 and n % batch_size < batch_size / 2.0:
        batch_size -= 1
    num_batches = n // batch_size
    for i in range(num_batches):
        yield data[i * batch_size : (i + 1) * batch_size]
    if num_batches * batch_size < n:
        yield data[num_batches * batch_size :]


def is_frame_number_in_ab_sections(
    frame_no: int, ab_sections: Optional[Iterable[range]]
) -> bool:
    """True when frame_no falls inside any user AB section (or none are set)."""
    if not ab_sections:
        return True
    return any(frame_no in section for section in ab_sections)


def expand_frame_ranges(
    frame_ranges: Sequence[Range],
    backward_frame_count: int,
    forward_frame_count: int,
) -> List[Range]:
    """Grow each (start, end) range outward without creating overlaps.

    Starts are clamped to >= 1. A range's forward growth stops before the next
    range begins; when two ranges were already back-to-back (gap of exactly 1)
    the boundary is left untouched. Overlap with the previously-emitted range
    is resolved by pushing the start just past it; if that inverts the range
    the original range is kept. (inpaint_tools.py:244-301)
    """
    if not frame_ranges:
        return []
    ordered = sorted(frame_ranges)
    out: List[Range] = []
    for i, (start, end) in enumerate(ordered):
        new_start = max(1, start - backward_frame_count)
        new_end = end + forward_frame_count
        if i + 1 < len(ordered):
            next_start = ordered[i + 1][0]
            if new_end >= next_start:
                if next_start - end == 1:
                    new_end = end
                else:
                    new_end = min(new_end, next_start - 1)
        if out and new_start <= out[-1][1]:
            new_start = out[-1][1] + 1
        if new_start <= new_end:
            out.append((new_start, new_end))
        else:
            out.append((start, end))
    return out


def filter_and_merge_intervals(
    intervals: Sequence[Range], target_length: int
) -> List[Range]:
    """Ensure inpainting intervals are at least ``target_length`` frames.

    Single-frame intervals are symmetrically widened by (target_length-1)//2
    without touching their neighbours; then overlapping/adjacent intervals are
    merged whenever either party is still shorter than target_length.
    (subtitle_detect.py:260-293)
    """
    if not intervals:
        return []
    ordered = sorted(intervals, key=lambda r: r[0])
    half = (target_length - 1) // 2
    widened: List[Range] = []
    for i, (start, end) in enumerate(ordered):
        if start == end:
            prev_end = widened[-1][1] if widened else float("-inf")
            next_start = ordered[i + 1][0] if i + 1 < len(ordered) else float("inf")
            lo = max(start - half, prev_end + 1)
            hi = min(start + half, next_start - 1)
            if hi < lo:
                lo, hi = start, start
            widened.append((int(lo), int(hi)))
        else:
            widened.append((start, end))
    merged: List[Range] = [widened[0]]
    for start, end in widened[1:]:
        last_start, last_end = merged[-1]
        touching = start <= last_end + 1
        short = (end - start + 1) < target_length or (last_end - last_start + 1) < target_length
        if touching and short:
            merged[-1] = (last_start, max(last_end, end))
        else:
            merged.append((start, end))
    return merged


def find_continuous_ranges(frame_no_box_dict: Dict[int, object]) -> List[Range]:
    """Collapse sorted frame numbers into maximal consecutive (start, end) runs.

    (subtitle_detect.py:218-235)
    """
    numbers = sorted(frame_no_box_dict.keys())
    if not numbers:
        return []
    ranges: List[Range] = []
    start = numbers[0]
    for prev, cur in zip(numbers, numbers[1:]):
        if cur - prev != 1:
            ranges.append((start, prev))
            start = cur
    ranges.append((start, numbers[-1]))
    return ranges


def find_continuous_ranges_with_same_mask(
    frame_no_box_dict: Dict[int, object]
) -> List[Range]:
    """Like find_continuous_ranges but also split where the box set changes.

    Consecutive frames whose detected box lists differ start a new range, so
    each emitted range shares one mask. (subtitle_detect.py:238-258)
    """
    numbers = sorted(frame_no_box_dict.keys())
    if not numbers:
        return []
    ranges: List[Range] = []
    start = numbers[0]
    for prev, cur in zip(numbers, numbers[1:]):
        if cur - prev != 1 or frame_no_box_dict[cur] != frame_no_box_dict[prev]:
            ranges.append((start, prev))
            start = cur
    ranges.append((start, numbers[-1]))
    return ranges


Box = Tuple[int, int, int, int]  # (xmin, xmax, ymin, ymax)


def are_similar(
    region1: Box, region2: Box, tol_x: int = 20, tol_y: int = 20
) -> bool:
    """Boxes match when x-edges are within tol_x and y-edges within tol_y.

    (subtitle_detect.py:172-179; tolerances from backend/config.py:65-66)
    """
    xmin1, xmax1, ymin1, ymax1 = region1
    xmin2, xmax2, ymin2, ymax2 = region2
    return (
        abs(xmin1 - xmin2) <= tol_x
        and abs(xmax1 - xmax2) <= tol_x
        and abs(ymin1 - ymin2) <= tol_y
        and abs(ymax1 - ymax2) <= tol_y
    )


def unify_regions(
    raw_regions: Dict[int, List[Box]], tol_x: int = 20, tol_y: int = 20
) -> Dict[int, List[Box]]:
    """Snap jittering per-frame boxes to the previous frame's box when similar.

    Walking frames in order, box #i of the current frame is replaced by box #i
    of the previous (already-unified) frame whenever the two are within
    tolerance — stabilising masks across a subtitle's lifetime.
    (subtitle_detect.py:181-215)
    """
    if not raw_regions:
        return raw_regions
    keys = sorted(raw_regions.keys())
    unified: Dict[int, List[Box]] = {keys[0]: raw_regions[keys[0]]}
    last_key = keys[0]
    for key in keys[1:]:
        prev_boxes = unified[last_key]
        new_boxes: List[Box] = []
        for idx, region in enumerate(raw_regions[key]):
            anchor = prev_boxes[idx] if idx < len(prev_boxes) else None
            if anchor is not None and are_similar(region, anchor, tol_x, tol_y):
                new_boxes.append(anchor)
            else:
                new_boxes.append(region)
        unified[key] = new_boxes
        last_key = key
    return unified
