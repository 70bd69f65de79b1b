"""Scene-cut detection on the host (copies of ``vsr_tpu/scenes/content.py``
and ``vsr_tpu/scenes/detectors.py``)."""

from vsr_tpu_torch.scenes.content import (
    ContentDetectorParams,
    detect_scene_cuts,
    get_scene_div_frame_no,
)
from vsr_tpu_torch.scenes.detectors import (
    AdaptiveDetector,
    FadeMethod,
    StatsManager,
    ThresholdDetector,
    detect_scene_cuts_adaptive,
    detect_scene_cuts_threshold,
)

__all__ = [
    "ContentDetectorParams",
    "detect_scene_cuts",
    "get_scene_div_frame_no",
    "AdaptiveDetector",
    "FadeMethod",
    "StatsManager",
    "ThresholdDetector",
    "detect_scene_cuts_adaptive",
    "detect_scene_cuts_threshold",
]
