"""Typed configuration for the vsr_tpu_torch pipeline.

A copy of ``vsr_tpu/config.py``: the same fields, defaults, clamps and JSON
format, so one ``config/config.json`` loads into both packages. Fields the
port does not read yet (detection, ProPainter) are kept for that reason.
``use_pallas`` keeps its name: on the port it switches the hand-written CUDA
kernels on.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from dataclasses import dataclass
from typing import List, Tuple


class InpaintMode(enum.Enum):
    """Inpainting algorithm selector (ref: backend/tools/constant.py:4-12)."""

    STTN_AUTO = "sttn-auto"
    STTN_DET = "sttn-det"
    LAMA = "lama"
    PROPAINTER = "propainter"
    OPENCV = "opencv"


class SubtitleDetectMode(enum.Enum):
    """Text-detection model selector (ref: backend/tools/constant.py:15-20)."""

    PP_OCRv5_MOBILE = "PP_OCRv5_MOBILE"
    PP_OCRv5_SERVER = "PP_OCRv5_SERVER"


def _clamp(name: str, value: int, lo: int, hi: int) -> int:
    if not (lo <= value <= hi):
        raise ValueError(f"config.{name}={value} out of range [{lo}, {hi}]")
    return value


@dataclass
class Config:
    """All pipeline hyper-parameters.

    Defaults mirror the reference's QConfig items one-for-one
    (ref: backend/config.py:43-109); ranges enforced in __post_init__.
    """

    # Subtitle selection areas as relative "ymin,ymax,xmin,xmax;..." string
    # (ref: backend/config.py:43)
    subtitle_selection_areas: str = "0.88,0.99,0.15,0.85"

    # Algorithm selectors (ref: backend/config.py:53-55)
    inpaint_mode: InpaintMode = InpaintMode.STTN_AUTO
    subtitle_detect_mode: SubtitleDetectMode = SubtitleDetectMode.PP_OCRv5_SERVER

    # UI locale, one of vsr_tpu_torch.i18n.available_locales()
    # (ref: backend/config.py:123-126)
    interface: str = "en"

    # Detection geometry tolerances, pixels (ref: backend/config.py:59-66)
    subtitle_yx_axis_difference_pixel: int = 10   # taller-than-wide => not a subtitle
    subtitle_area_deviation_pixel: int = 10       # mask dilation
    subtitle_area_y_axis_difference_pixel: int = 20
    subtitle_area_pixel_tolerance_y: int = 20
    subtitle_area_pixel_tolerance_x: int = 20

    # Timeline expansion (ref: backend/config.py:67-68)
    subtitle_timeline_backward_frame_count: int = 3
    subtitle_timeline_forward_frame_count: int = 3

    # STTN knobs (ref: backend/config.py:89-94)
    sttn_neighbor_stride: int = 5
    sttn_reference_length: int = 10
    sttn_max_load_num: int = 50

    # ProPainter knobs (ref: backend/config.py:100)
    propainter_max_load_num: int = 70
    propainter_window_batch: int = 1
    propainter_neighbor_length: int = 10
    propainter_ref_stride: int = 10
    propainter_subvideo_length: int = 80
    propainter_raft_iters: int = 20

    # Hardware acceleration toggle (ref: backend/config.py:103).
    hardware_acceleration: bool = True

    # ---- knobs with no reference analog ----
    # Windows evaluated per device step in the STTN sweep (0 = all windows
    # of a chunk at once).
    window_batch: int = 1
    # Compute dtype of the model forward ("bfloat16" on the card, "float32"
    # for bit-accurate CPU tests).
    compute_dtype: str = "bfloat16"
    # Use the hand-written kernels (the field name is the JAX package's).
    use_pallas: bool = True
    # Video writer settings (ref hardcodes libx264 crf18 fast: video_io.py:62-77)
    encode_crf: int = 18
    encode_preset: str = "fast"

    def __post_init__(self) -> None:
        _clamp("subtitle_yx_axis_difference_pixel", self.subtitle_yx_axis_difference_pixel, 0, 300)
        _clamp("subtitle_area_deviation_pixel", self.subtitle_area_deviation_pixel, 1, 300)
        _clamp("subtitle_area_y_axis_difference_pixel", self.subtitle_area_y_axis_difference_pixel, 0, 300)
        _clamp("subtitle_area_pixel_tolerance_y", self.subtitle_area_pixel_tolerance_y, 0, 300)
        _clamp("subtitle_area_pixel_tolerance_x", self.subtitle_area_pixel_tolerance_x, 0, 300)
        _clamp("subtitle_timeline_backward_frame_count", self.subtitle_timeline_backward_frame_count, 0, 300)
        _clamp("subtitle_timeline_forward_frame_count", self.subtitle_timeline_forward_frame_count, 0, 300)
        _clamp("sttn_neighbor_stride", self.sttn_neighbor_stride, 1, 100)
        _clamp("sttn_reference_length", self.sttn_reference_length, 1, 100)
        _clamp("sttn_max_load_num", self.sttn_max_load_num, 1, 300)
        _clamp("propainter_max_load_num", self.propainter_max_load_num, 1, 300)
        _clamp("propainter_window_batch", self.propainter_window_batch, 1, 8)

    # ref: backend/config.py:94 — clip gap must cover stride*ref_length
    def get_sttn_max_load_num(self) -> int:
        return max(self.sttn_max_load_num,
                   self.sttn_neighbor_stride * self.sttn_reference_length)

    # ---- persistence ----
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["inpaint_mode"] = self.inpaint_mode.value
        d["subtitle_detect_mode"] = self.subtitle_detect_mode.value
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        d = json.loads(text)
        if "inpaint_mode" in d:
            d["inpaint_mode"] = InpaintMode(d["inpaint_mode"])
        if "subtitle_detect_mode" in d:
            d["subtitle_detect_mode"] = SubtitleDetectMode(d["subtitle_detect_mode"])
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        return cls(**d)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        if os.path.exists(path):
            with open(path) as f:
                return cls.from_json(f.read())
        return cls()

    def parse_selection_areas(self, height: int, width: int) -> List[Tuple[int, int, int, int]]:
        """Relative area string -> absolute (ymin, ymax, xmin, xmax) pixel boxes."""
        areas = []
        for part in self.subtitle_selection_areas.split(";"):
            part = part.strip()
            if not part:
                continue
            ymin, ymax, xmin, xmax = (float(v) for v in part.split(","))
            areas.append((int(ymin * height), int(ymax * height),
                          int(xmin * width), int(xmax * width)))
        return areas
