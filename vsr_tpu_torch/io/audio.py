"""Audio remux: carry the source audio track into the inpainted video
(copy of ``vsr_tpu/io/audio.py``).

Mirrors SubtitleRemover.merge_audio_to_video (backend/main.py:418-460):
extract the audio stream with codec copy, then mux it into the silent output,
falling back to a plain copy of the silent video when ffmpeg is missing or
either step fails.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Callable, Optional

from vsr_tpu_torch.i18n import tr
from vsr_tpu_torch.io.ffmpeg import find_ffmpeg


def merge_audio_to_video(
    source_video: str,
    silent_video: str,
    output_path: str,
    log: Optional[Callable[[str], None]] = None,
    timeout: int = 600,
) -> bool:
    """Produce output_path = silent_video frames + source_video audio.

    Returns True when the audio was carried over, False when the output is a
    plain copy of the silent video (no audio available / ffmpeg missing).
    """
    log = log or (lambda msg: None)
    ffmpeg = find_ffmpeg()
    if ffmpeg is None:
        log(tr.text("Main", "FFmpegMissingNote"))
        _copy(silent_video, output_path)
        return False

    tmp = tempfile.NamedTemporaryFile(suffix=".aac", delete=False)
    tmp.close()
    try:
        extract = [
            ffmpeg, "-y", "-i", source_video,
            "-acodec", "copy", "-vn", "-loglevel", "error", tmp.name,
        ]
        try:
            subprocess.check_output(extract, stdin=subprocess.DEVNULL, timeout=timeout)
        except Exception as e:  # no audio stream, unsupported codec, ...
            log(tr.text("Main", "FailToExtractAudio", e))
            _copy(silent_video, output_path)
            return False

        merge = [
            ffmpeg, "-y", "-i", silent_video, "-i", tmp.name,
            "-vcodec", "copy", "-acodec", "copy",
            "-loglevel", "error", output_path,
        ]
        try:
            subprocess.check_output(merge, stdin=subprocess.DEVNULL, timeout=timeout)
        except Exception as e:
            log(tr.text("Main", "FailToMergeAudio", e))
            _copy(silent_video, output_path)
            return False
        return True
    finally:
        if os.path.exists(tmp.name):
            try:
                os.remove(tmp.name)
            except OSError:
                pass


def _copy(src: str, dst: str) -> None:
    if os.path.abspath(src) != os.path.abspath(dst):
        shutil.copy2(src, dst)
