"""The remaining scene-detector family: adaptive and threshold detectors
plus the frame-metrics stats store (a copy of ``vsr_tpu/scenes/detectors.py``
on the port's own ``scenes/content.py`` and ``io/video.py``).

The pipeline itself only ever runs the content detector
(backend/tools/subtitle_detect.py:158-170 -> scenes/content.py); the
reference nevertheless vendors the full PySceneDetect detector set
(backend/scenedetect/detectors/). This module covers the rest of that
surface with the same scoring math and cut semantics:

* ``AdaptiveDetector`` — content scores divided by a rolling two-sided
  window average (adaptive_detector.py:30-175): cut when the ratio exceeds
  ``adaptive_threshold`` AND the raw score exceeds ``min_content_val``,
  respecting ``min_scene_len``; zero-average frames with a big-enough score
  ratio-saturate at 255.
* ``ThresholdDetector`` — fade-to-level detection on the mean 8-bit RGB
  intensity (threshold_detector.py:56-207): fade-out when the average
  crosses ``threshold`` (FLOOR: below; CEILING: above), cut placed between
  fade-out and fade-in shifted by ``fade_bias``, optional ``add_final_scene``
  for videos ending on a fade-out.
* ``StatsManager`` — per-frame metric store with CSV save/load
  (stats_manager.py:86+), so thresholds can be tuned offline.

The reference's ``MotionDetector`` body is itself
``raise NotImplementedError()`` upstream (motion_detector.py:44) — there is
deliberately no port of dead code.

All host-side numpy by design: these passes are decode-bound (see
scenes/content.py's rationale).
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from vsr_tpu_torch.scenes.content import ContentDetectorParams, frame_scores


class StatsManager:
    """Per-frame metric key-value store with CSV round-trip
    (ref stats_manager.py:86 — floats/ints only, one row per frame)."""

    def __init__(self) -> None:
        self._metrics: Dict[int, Dict[str, float]] = {}

    def set_metrics(self, frame_num: int, metrics: Dict[str, float]) -> None:
        self._metrics.setdefault(frame_num, {}).update(metrics)

    def get_metrics(self, frame_num: int, keys: List[str]) -> List[Optional[float]]:
        row = self._metrics.get(frame_num, {})
        return [row.get(k) for k in keys]

    def metrics_exist(self, frame_num: int, keys: List[str]) -> bool:
        row = self._metrics.get(frame_num)
        return row is not None and all(k in row for k in keys)

    def keys(self) -> List[str]:
        out: List[str] = []
        for row in self._metrics.values():
            for k in row:
                if k not in out:
                    out.append(k)
        return out

    def save_to_csv(self, path: str) -> None:
        keys = self.keys()
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["Frame Number"] + keys)
            for frame_num in sorted(self._metrics):
                row = self._metrics[frame_num]
                w.writerow([frame_num] + [row.get(k, "") for k in keys])

    def load_from_csv(self, path: str) -> int:
        n = 0
        with open(path, newline="") as f:
            r = csv.reader(f)
            header = next(r)
            keys = header[1:]
            for row in r:
                vals = {k: float(v) for k, v in zip(keys, row[1:]) if v != ""}
                self.set_metrics(int(row[0]), vals)
                n += 1
        return n


@dataclass
class AdaptiveDetector:
    """Rolling-ratio content detector (ref adaptive_detector.py:30-175).

    Feed per-frame content scores (``frame_scores`` output; frame 0 scores
    0.0 like the reference's first processed frame) through
    ``process_score``; cuts trail the input by ``window_width`` frames."""

    adaptive_threshold: float = 3.0
    min_scene_len: int = 15
    window_width: int = 2
    min_content_val: float = 15.0
    stats_manager: Optional[StatsManager] = None
    _buffer: List = field(default_factory=list)
    _last_cut: Optional[int] = None

    @property
    def event_buffer_length(self) -> int:
        return self.window_width

    @property
    def _ratio_key(self) -> str:
        return f"adaptive_ratio (w={self.window_width})"

    def process_score(self, frame_num: int, score: float) -> List[int]:
        if self.stats_manager is not None:
            self.stats_manager.set_metrics(frame_num, {"content_val": score})
        required = 1 + 2 * self.window_width
        self._buffer.append((frame_num, score))
        if len(self._buffer) < required:
            return []
        self._buffer = self._buffer[-required:]
        target_num, target_score = self._buffer[self.window_width]
        window_avg = sum(
            s for i, (_, s) in enumerate(self._buffer)
            if i != self.window_width) / (2.0 * self.window_width)

        if abs(window_avg) >= 1e-5:
            ratio = min(target_score / window_avg, 255.0)
        elif target_score >= self.min_content_val:
            ratio = 255.0  # would divide by zero: saturate
        else:
            ratio = 0.0
        if self.stats_manager is not None:
            self.stats_manager.set_metrics(target_num, {self._ratio_key: ratio})

        if ratio >= self.adaptive_threshold and target_score >= self.min_content_val:
            if self._last_cut is None or (
                    target_num - self._last_cut) >= self.min_scene_len:
                self._last_cut = target_num
                return [target_num]
        return []


class FadeMethod(Enum):
    """ref threshold_detector.py:63-68"""
    FLOOR = 0
    CEILING = 1


def compute_frame_average(frame: np.ndarray) -> float:
    """Mean 8-bit intensity over all pixels x channels
    (ref threshold_detector.py:34-53)."""
    return float(frame.sum()) / float(
        frame.shape[0] * frame.shape[1] * frame.shape[2])


@dataclass
class ThresholdDetector:
    """Fade in/out detector on mean frame intensity
    (ref threshold_detector.py:56-207)."""

    threshold: float = 12.0
    min_scene_len: int = 15
    fade_bias: float = 0.0
    add_final_scene: bool = False
    method: FadeMethod = FadeMethod.FLOOR
    stats_manager: Optional[StatsManager] = None
    _processed: bool = False
    _last_fade_frame: int = 0
    _last_fade_type: Optional[str] = None
    _last_scene_cut: Optional[int] = None

    def _is_out(self, frame_avg: float) -> bool:
        if self.method is FadeMethod.FLOOR:
            return frame_avg < self.threshold
        return frame_avg >= self.threshold

    def process_frame(self, frame_num: int, frame: np.ndarray) -> List[int]:
        if self._last_scene_cut is None:
            self._last_scene_cut = frame_num
        frame_avg = compute_frame_average(frame)
        if self.stats_manager is not None:
            self.stats_manager.set_metrics(frame_num, {"average_rgb": frame_avg})
        cuts: List[int] = []
        if self._processed:
            if self._last_fade_type == "in" and self._is_out(frame_avg):
                self._last_fade_type = "out"
                self._last_fade_frame = frame_num
            elif self._last_fade_type == "out" and not self._is_out(frame_avg):
                if (frame_num - self._last_scene_cut) >= self.min_scene_len:
                    f_out = self._last_fade_frame
                    # cut midway between fade-out and fade-in, shifted by bias
                    f_split = int((frame_num + f_out
                                   + int(self.fade_bias * (frame_num - f_out)))
                                  / 2)
                    cuts.append(f_split)
                    self._last_scene_cut = frame_num
                self._last_fade_type = "in"
                self._last_fade_frame = frame_num
        else:
            self._last_fade_frame = 0
            self._last_fade_type = "out" if frame_avg < self.threshold else "in"
        self._processed = True
        return cuts

    def post_process(self, frame_num: int) -> List[int]:
        """Final cut at the last fade-out for videos ending faded
        (ref threshold_detector.py:186-207)."""
        if (self._last_fade_type == "out" and self.add_final_scene
                and self._last_scene_cut is not None
                and (frame_num - self._last_scene_cut) >= self.min_scene_len):
            return [self._last_fade_frame]
        return []


def detect_scene_cuts_adaptive(
    video_path: str,
    detector: Optional[AdaptiveDetector] = None,
    content_params: Optional[ContentDetectorParams] = None,
    batch: int = 64,
) -> List[int]:
    """Run AdaptiveDetector over a video's content scores (the reference's
    SceneManager.detect_scenes driving AdaptiveDetector)."""
    import cv2

    from vsr_tpu_torch.io.video import VideoReader
    from vsr_tpu_torch.scenes.content import compute_downscale_factor

    detector = detector or AdaptiveDetector()
    params = content_params or ContentDetectorParams()
    reader = VideoReader(video_path)
    factor = compute_downscale_factor(reader.info.width)
    cuts: List[int] = []
    prev_hsv = None
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
            if prev_hsv is None:
                cuts.extend(detector.process_score(0, 0.0))  # first frame
                base = 1
            else:
                base = frame_no
            for i, score in enumerate(scores):
                cuts.extend(detector.process_score(base + i, float(score)))
            frame_no += len(frames)
            prev_hsv = hsv[-1]
            if len(frames) < batch:
                break
    finally:
        reader.release()
    return cuts


def detect_scene_cuts_threshold(
    video_path: str,
    detector: Optional[ThresholdDetector] = None,
) -> List[int]:
    """Run ThresholdDetector over a video (full-resolution frames, like the
    reference — intensity averages don't downscale-commute exactly)."""
    from vsr_tpu_torch.io.video import VideoReader

    detector = detector or ThresholdDetector()
    reader = VideoReader(video_path)
    cuts: List[int] = []
    frame_no = 0
    try:
        while True:
            ok, frame = reader.read()
            if not ok:
                break
            cuts.extend(detector.process_frame(frame_no, frame))
            frame_no += 1
    finally:
        reader.release()
    cuts.extend(detector.post_process(frame_no - 1))
    return cuts
