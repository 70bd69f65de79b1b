from vsr_tpu_torch.io.audio import merge_audio_to_video
from vsr_tpu_torch.io.ffmpeg import find_ffmpeg
from vsr_tpu_torch.io.video import (
    FramePrefetcher,
    VideoReader,
    VideoWriter,
    read_video_info,
)

__all__ = [
    "FramePrefetcher",
    "VideoReader",
    "VideoWriter",
    "read_video_info",
    "find_ffmpeg",
    "merge_audio_to_video",
]
