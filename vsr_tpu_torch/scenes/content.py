"""Content-based scene-cut detection (copy of ``vsr_tpu/scenes/content.py``).

Replaces the vendored 7.6k-LoC PySceneDetect subset with the one code path
the pipeline actually uses (backend/tools/subtitle_detect.py:158-170 ->
backend/scenedetect/__init__.py:104 with ContentDetector): HSV mean-pixel-
distance scoring with threshold 27, min-scene-len 15, auto downscale to
~256px width (scene_manager.py:109-144 semantics).

Scoring math parity (detectors/content_detector.py:145-216):
  score = (|dH| + |dS| + |dV|) / 3  (mean abs pixel distance per channel)
  cut when score >= threshold and >= min_scene_len frames since last cut.

Host-side by design: the pass is decode-bound (cv2 HSV on ~256px-wide frames
is microseconds/frame); shipping frames to the card for three subtractions
would spend more on PCIe than it saves. The scoring loop is vectorized numpy
over frame batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import cv2
import numpy as np

from vsr_tpu_torch.io.video import VideoReader

DEFAULT_MIN_WIDTH = 256


@dataclass
class ContentDetectorParams:
    threshold: float = 27.0
    min_scene_len: int = 15
    weights: tuple = (1.0, 1.0, 1.0)  # (hue, sat, lum); edges unused (weight 0)


def compute_downscale_factor(frame_width: int, effective_width: int = DEFAULT_MIN_WIDTH) -> int:
    if frame_width < effective_width:
        return 1
    return frame_width // effective_width


def frame_scores(hsv_frames: np.ndarray, weights=(1.0, 1.0, 1.0)) -> np.ndarray:
    """[N, H, W, 3] int HSV -> [N-1] content scores between consecutive frames."""
    x = hsv_frames.astype(np.int32)
    diffs = np.abs(x[1:] - x[:-1]).mean(axis=(1, 2))  # [N-1, 3]
    w = np.asarray(weights, np.float64)
    return (diffs @ w) / np.abs(w).sum()


def detect_scene_cuts(
    video_path: str,
    params: Optional[ContentDetectorParams] = None,
    batch: int = 64,
) -> List[int]:
    """Return 0-based frame numbers where cuts occur (frame starting a scene)."""
    params = params or ContentDetectorParams()
    reader = VideoReader(video_path)
    factor = compute_downscale_factor(reader.info.width)
    cuts: List[int] = []
    last_cut = 0
    prev_hsv: Optional[np.ndarray] = None
    frame_no = 0
    try:
        while True:
            frames = []
            for _ in range(batch):
                ok, frame = reader.read()
                if not ok:
                    break
                if factor > 1:
                    frame = frame[::factor, ::factor]
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2HSV))
            if not frames:
                break
            hsv = np.stack(frames)
            if prev_hsv is not None:
                hsv = np.concatenate([prev_hsv[None], hsv])
            scores = frame_scores(hsv, params.weights)
            base = frame_no if prev_hsv is not None else frame_no + 1
            for i, score in enumerate(scores):
                num = base + i
                if score >= params.threshold and (num - last_cut) >= params.min_scene_len:
                    cuts.append(num)
                    last_cut = num
            frame_no += len(frames)
            prev_hsv = hsv[-1]
            if len(frames) < batch:
                break
    finally:
        reader.release()
    return cuts


def get_scene_div_frame_no(video_path: str, params: Optional[ContentDetectorParams] = None) -> List[int]:
    """1-based frame numbers where a new scene begins (pipeline convention,
    ref subtitle_detect.py:157-170: scene start frame + 1, skipping frame 0)."""
    return [cut + 1 for cut in detect_scene_cuts(video_path, params)]
