"""ffmpeg binary discovery (copy of ``vsr_tpu/io/ffmpeg.py``).

The reference bundles per-OS ffmpeg binaries and merges split blobs
(backend/tools/ffmpeg_cli.py:8-36). We instead locate a system ffmpeg and
degrade gracefully: every consumer has a cv2 fallback, so a missing ffmpeg
never blocks the pipeline — it only changes the encoder (mp4v instead of
libx264) and disables audio remux.
"""

from __future__ import annotations

import os
import shutil
from functools import lru_cache
from typing import Optional


@lru_cache(maxsize=1)
def find_ffmpeg() -> Optional[str]:
    """Return a path to an ffmpeg executable, or None if unavailable.

    Search order: $VSR_FFMPEG override, PATH, common install locations.
    """
    env = os.environ.get("VSR_FFMPEG")
    if env and os.path.isfile(env) and os.access(env, os.X_OK):
        return env
    path = shutil.which("ffmpeg")
    if path:
        return path
    for candidate in ("/usr/bin/ffmpeg", "/usr/local/bin/ffmpeg", "/opt/ffmpeg/ffmpeg"):
        if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
            return candidate
    return None


def has_ffmpeg() -> bool:
    return find_ffmpeg() is not None
