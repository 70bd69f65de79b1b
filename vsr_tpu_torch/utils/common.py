"""Small file/media helpers (parity with backend/tools/common_tools.py and
backend/tools/merge_video.py); a copy of ``vsr_tpu/utils/common.py``."""

from __future__ import annotations

import os
from typing import Optional

import cv2
import numpy as np

VIDEO_EXTENSIONS = {".mp4", ".avi", ".mkv", ".mov", ".webm", ".flv", ".ts",
                    ".m4v", ".wmv", ".mpg", ".mpeg"}
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


def is_image_file(path: str) -> bool:
    return os.path.splitext(str(path))[-1].lower() in IMAGE_EXTENSIONS


def is_video_file(path: str) -> bool:
    return os.path.splitext(str(path))[-1].lower() in VIDEO_EXTENSIONS


def is_video_or_image(path: str) -> bool:
    return is_image_file(path) or is_video_file(path)


def read_image(path: str) -> Optional[np.ndarray]:
    """Unicode-path-safe image read (ref common_tools.read_image)."""
    try:
        data = np.fromfile(path, dtype=np.uint8)
        return cv2.imdecode(data, cv2.IMREAD_COLOR)
    except Exception:
        return None


def write_image(path: str, image: np.ndarray) -> bool:
    """Unicode-path-safe image write via imencode+tofile."""
    ext = os.path.splitext(path)[-1] or ".png"
    ok, buf = cv2.imencode(ext, image)
    if not ok:
        return False
    buf.tofile(path)
    return True


def merge_videos_side_by_side(
    left_path: str, right_path: str, out_path: str,
    label_left: str = "before", label_right: str = "after",
) -> int:
    """Horizontal-concat comparison video (ref backend/tools/merge_video.py:4).

    Returns the number of frames written; stops at the shorter input.
    """
    cap_l = cv2.VideoCapture(left_path)
    cap_r = cv2.VideoCapture(right_path)
    fps = cap_l.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap_l.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap_l.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w * 2, h))
    n = 0
    try:
        while True:
            ok_l, fl = cap_l.read()
            ok_r, fr = cap_r.read()
            if not (ok_l and ok_r):
                break
            if fr.shape[:2] != (h, w):
                fr = cv2.resize(fr, (w, h))
            canvas = np.concatenate([fl, fr], axis=1)
            for text, x in ((label_left, 10), (label_right, w + 10)):
                cv2.putText(canvas, text, (x, 30), cv2.FONT_HERSHEY_SIMPLEX,
                            1.0, (0, 255, 0), 2)
            writer.write(canvas)
            n += 1
    finally:
        cap_l.release()
        cap_r.release()
        writer.release()
    return n
