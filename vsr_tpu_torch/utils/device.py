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


def items_per_chunk(device: torch.device, requested: int, bytes_per_item: float,
                    fraction: float = 0.5) -> int:
    """How many items of ``bytes_per_item`` fit in ``fraction`` of the free
    device memory (the driver's free memory plus what PyTorch's allocator
    holds unused): at most ``requested``, at least 1. Returns ``requested``
    on the CPU."""
    if device.type != "cuda":
        return requested
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(1, min(requested, int(free * fraction // max(bytes_per_item, 1))))


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
