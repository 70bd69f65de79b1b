"""Subtitle detection over video frames (PyTorch): counterpart of
``vsr_tpu/detect/detector.py`` (the reference's backend/tools/
subtitle_detect.py:16-132).

* fps-adaptive sampling (step 4/3/2 for >=60/>=30/else fps, ref :29-39);
* the sampled frames, resized to the 960-long-side bucket, go through the
  DBNet forward in batches of ``batch_size`` on ``device``; DBPostProcess
  and the area filter run on the host (ref :56-82);
* gap interpolation between consecutive detected samples (gap <= 2*step,
  ref :112-124) and region unification (ref :181-215, masks/intervals.py).

The JAX package pads a short last batch to ``batch_size`` (one XLA program
per resolution); PyTorch runs any batch size, and BatchNorm runs on its
running statistics, so each frame's result does not depend on its batch.
The forward runs in fp32 with cuDNN's TF32 off: the box decisions threshold
the map at 0.3 and 0.6 (detect/postprocess.py), and TF32 keeps only ~3
decimal digits of each product.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vsr_tpu_torch.config import Config, SubtitleDetectMode
from vsr_tpu_torch.detect.boxes import get_coordinates
from vsr_tpu_torch.detect.dbnet import DBNet
from vsr_tpu_torch.detect.postprocess import db_postprocess
from vsr_tpu_torch.detect.preprocess import preprocess_frame
from vsr_tpu_torch.inpaint.weights import load_dbnet_weights
from vsr_tpu_torch.io.video import VideoReader, read_video_info
from vsr_tpu_torch.masks.intervals import (
    find_continuous_ranges,
    find_continuous_ranges_with_same_mask,
    is_frame_number_in_ab_sections,
    split_range_by_scene,
    unify_regions,
)
from vsr_tpu_torch.utils.device import resolve_device

Box = Tuple[int, int, int, int]  # (xmin, xmax, ymin, ymax)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full fp32 inside the block (restored after)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class SubtitleDetector:
    def __init__(
        self,
        video_path: str,
        sub_areas: Optional[Sequence[Tuple[int, int, int, int]]] = None,
        config: Optional[Config] = None,
        checkpoint_path: Optional[str] = None,
        batch_size: int = 8,
        device: Union[str, torch.device] = "cuda",
    ):
        self.video_path = video_path
        self.sub_areas = list(sub_areas or [])
        self.config = config or Config()
        self.checkpoint_path = checkpoint_path
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._model: Optional[DBNet] = None
        self._ready = False
        self.sample_step = self._compute_sample_step()

    def _compute_sample_step(self) -> int:
        """>=8 OCR samples/s (ref :29-39)."""
        try:
            fps = read_video_info(self.video_path).fps
        except Exception:
            return 3
        if fps >= 60:
            return 4
        if fps >= 30:
            return 3
        return 2

    # ---- model plumbing ----
    @property
    def model(self) -> DBNet:
        if self._model is None:
            preset = ("server"
                      if self.config.subtitle_detect_mode == SubtitleDetectMode.PP_OCRv5_SERVER
                      else "mobile")
            self._model = DBNet(preset=preset)
        return self._model

    def _ensure_weights(self) -> DBNet:
        if not self._ready:
            load_dbnet_weights(self.model, self.checkpoint_path)
            self._model = self.model.to(self.device, torch.float32).eval()
            self._ready = True
        return self.model

    @torch.inference_mode()
    def probability_maps(self, batch: np.ndarray) -> np.ndarray:
        """DBNet forward: [B, H, W, 3] normalized float32 -> [B, H, W, 1]."""
        model = self._ensure_weights()
        x = torch.from_numpy(batch).to(self.device)
        with _no_tf32():
            return model(x).cpu().numpy()

    # ---- detection ----
    def _detect_batch(self, frames_bgr: List[np.ndarray]) -> List[List[Box]]:
        """DBNet over a batch of equally-sized BGR frames -> boxes per frame."""
        h, w = frames_bgr[0].shape[:2]
        prob = self.probability_maps(np.stack([preprocess_frame(f) for f in frames_bgr]))
        results: List[List[Box]] = []
        for p in prob:
            quads = db_postprocess(p[..., 0], (h, w))
            results.append(get_coordinates([q.tolist() for q in quads]))
        return results

    def _filter_to_areas(self, boxes: List[Box]) -> List[Box]:
        """Keep boxes fully inside any user subtitle area (ref :60-81)."""
        if not self.sub_areas:
            return list(boxes)
        kept = []
        for xmin, xmax, ymin, ymax in boxes:
            for s_ymin, s_ymax, s_xmin, s_xmax in self.sub_areas:
                if (s_xmin <= xmin and xmax <= s_xmax
                        and s_ymin <= ymin and ymax <= s_ymax):
                    kept.append((xmin, xmax, ymin, ymax))
                    break
        return kept

    def detect_subtitle(self, img: np.ndarray) -> List[Box]:
        """Single-image detection + area filter (ref :56-82)."""
        return self._filter_to_areas(self._detect_batch([img])[0])

    def find_subtitle_frame_no(self, sub_remover=None) -> Dict[int, List[Box]]:
        """Sample frames, batch-detect, interpolate gaps, unify regions.

        Returns {frame_no (1-based): [(xmin, xmax, ymin, ymax), ...]}.
        """
        ab_sections = getattr(sub_remover, "ab_sections", None)
        reader = VideoReader(self.video_path)
        frame_count = reader.info.frame_count

        sampled_results: Dict[int, List[Box]] = {}
        pending: List[Tuple[int, np.ndarray]] = []

        def flush():
            if not pending:
                return
            frames = [f for _, f in pending]
            for (frame_no, _), boxes in zip(pending, self._detect_batch(frames)):
                kept = self._filter_to_areas(boxes)
                if kept:
                    sampled_results[frame_no] = kept
            pending.clear()

        current = 0
        try:
            while True:
                ok, frame = reader.read()
                if not ok:
                    break
                current += 1
                if not is_frame_number_in_ab_sections(current - 1, ab_sections):
                    continue
                if (current - 1) % self.sample_step == 0 or self.sample_step <= 1:
                    pending.append((current, frame))
                    if len(pending) >= self.batch_size:
                        flush()
                if sub_remover is not None and frame_count:
                    sub_remover.progress_total = (100.0 * current / frame_count) // 2
            flush()
        finally:
            reader.release()

        # gap interpolation (ref :112-124)
        out: Dict[int, List[Box]] = {}
        detected = sorted(sampled_results.keys())
        max_gap = self.sample_step * 2
        for f, next_f in zip(detected, detected[1:]):
            out[f] = sampled_results[f]
            if next_f - f <= max_gap:
                for fill in range(f + 1, next_f):
                    out[fill] = sampled_results[f]
        if detected:
            out[detected[-1]] = sampled_results[detected[-1]]

        out = unify_regions(
            out,
            tol_x=self.config.subtitle_area_pixel_tolerance_x,
            tol_y=self.config.subtitle_area_pixel_tolerance_y,
        )
        return {k: v for k, v in out.items() if v}

    # convenience passthroughs mirroring the reference static helpers
    find_continuous_ranges = staticmethod(find_continuous_ranges)
    find_continuous_ranges_with_same_mask = staticmethod(
        find_continuous_ranges_with_same_mask
    )
    split_range_by_scene = staticmethod(split_range_by_scene)
