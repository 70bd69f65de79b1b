"""Scene-cut detection on the host (copy of ``vsr_tpu/scenes/content.py``)."""

from vsr_tpu_torch.scenes.content import (
    ContentDetectorParams,
    detect_scene_cuts,
    get_scene_div_frame_no,
)

__all__ = ["ContentDetectorParams", "detect_scene_cuts", "get_scene_div_frame_no"]
