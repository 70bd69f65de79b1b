"""Device selection and memory-adaptive chunk sizing.

Counterpart of ``vsr_tpu/utils/device.py``. Every entry point of the port
takes an explicit device; asking for CUDA where there is none raises.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device(device), raising when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev


def adaptive_clip_len(
    device: torch.device, requested: int, frame_h: int, frame_w: int,
    bytes_per_pixel_frame: float = 24.0, minimum: int = 10,
) -> int:
    """Clamp a chunk length to what free device memory supports (the
    reference's free-VRAM clip_gap heuristic; the formula of
    vsr_tpu/utils/device.py:74-85). Returns ``requested`` on the CPU."""
    if device.type != "cuda":
        return requested
    free, _ = torch.cuda.mem_get_info(device)
    per_frame = frame_h * frame_w * bytes_per_pixel_frame
    max_frames = int(free * 0.6 / max(per_frame, 1))
    return max(min(requested, max_frames), minimum)
