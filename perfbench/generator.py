"""The one traffic generator. A traffic mix is a JSON file of parameters in
``perfbench/traffic/``; its ``"generator"`` key names the kind of stream:

* ``band_stream``: every frame of a 1080p video under one fixed selection
  area (``selection_area`` as relative ymin, ymax, xmin, xmax), as the
  subtitle remover's sttn-auto mode takes it;
* ``subtitle_timeline``: a timeline of subtitle lines, each a box set held
  for a run of frames, and gaps between them, as text detection reports it
  (``{frame number: [(xmin, xmax, ymin, ymax), ...]}``, numbered from 1).

Frames are seeded noise in a pool of ``pool_frames`` frames in host memory,
made on the card in slices; frame i of the stream is ``pool[i % len(pool)]``.

Every seed gets the same work in another order: a timeline is made of
periods of ``lines_per_period`` lines whose lengths, gaps, row counts, row
heights, widths and centre offsets are the same stratified values in every
period, each list shuffled by the seed. So runs with different seeds differ
only in order, and the share of frames covered is the same in every period.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")

Box = Tuple[int, int, int, int]  # (xmin, xmax, ymin, ymax)


def load_mix(name: str, traffic_dir: str = TRAFFIC_DIR) -> dict:
    with open(os.path.join(traffic_dir, f"{name}.json")) as f:
        return json.load(f)


def frame_pool(mix: dict, seed: int, device, slice_frames: int = 16) -> List[np.ndarray]:
    """``pool_frames`` seeded uint8 BGR noise frames [H, W, 3] in host memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (mix["height"], mix["width"], 3)
    pool = []
    for start in range(0, mix["pool_frames"], slice_frames):
        n = min(slice_frames, mix["pool_frames"] - start)
        block = torch.randint(0, 256, (n, *shape), generator=gen, device=device,
                              dtype=torch.uint8).cpu().numpy()
        pool.extend(block)
    return pool


def selection_box(mix: dict) -> Box:
    """The selection area as an absolute (xmin, xmax, ymin, ymax) box."""
    H, W = mix["height"], mix["width"]
    ymin, ymax, xmin, xmax = mix["selection_area"]
    return int(xmin * W), int(xmax * W), int(ymin * H), int(ymax * H)


def _stratified(lo: float, hi: float, k: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(k) + 0.5) / k


def timeline_lines(mix: dict, seed: int, n_frames: int) -> List[Tuple[int, int, List[Box]]]:
    """Subtitle lines (first frame, last frame, boxes) covering frames
    1..n_frames at least, numbered from 1; each line follows its gap."""
    H, W = mix["height"], mix["width"]
    k = mix["lines_per_period"]
    rng = np.random.default_rng(seed)
    lengths = np.rint(_stratified(*mix["line_frames"], k)).astype(int)
    gaps = np.rint(_stratified(*mix["gap_frames"], k)).astype(int)
    rows = (np.arange(k) < round(k * mix["two_row_share"])).astype(int) + 1
    heights = np.rint(_stratified(*mix["row_height"], 2 * k)).astype(int)
    widths = _stratified(*mix["width_share"], 2 * k)
    jitter = _stratified(-mix["x_centre_jitter"], mix["x_centre_jitter"], k)
    bottom = int(mix["bottom_row_ymax"] * H)
    lines = []
    frame = 1
    while frame <= n_frames:
        order = [rng.permutation(v) for v in (lengths, gaps, rows, jitter)]
        hs, ws = rng.permutation(heights), rng.permutation(widths)
        for j in range(k):
            length, gap, n_rows, dx = (v[j] for v in order)
            frame += int(gap)
            cx = W / 2 + dx * W
            boxes = []
            ymax = bottom
            for r in range(n_rows):
                h, w = int(hs[2 * j + r]), ws[2 * j + r] * W
                xmin, xmax = max(0, int(cx - w / 2)), min(W - 1, int(cx + w / 2))
                boxes.append((xmin, xmax, ymax - h, ymax))
                ymax -= h + mix["row_spacing"]
            lines.append((frame, frame + int(length) - 1, boxes))
            frame += int(length)
    return lines


def boxes_by_frame(lines) -> Dict[int, List[Box]]:
    """The detector's map: {frame number: boxes} over every line's frames."""
    return {f: list(boxes) for s, e, boxes in lines for f in range(s, e + 1)}
