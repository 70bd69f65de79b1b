"""Video decode/encode with background prefetch (copy of
``vsr_tpu/io/video.py``).

Replaces the reference's cv2.VideoCapture + daemon prefetch thread +
FFmpegVideoWriter pipe (backend/tools/video_io.py:12-104). Design goals:

* decode runs on a host thread feeding a bounded queue, so ffmpeg/cv2 I/O
  overlaps device compute (the device step never waits on single-frame reads);
* encode prefers an ffmpeg rawvideo/bgr24 stdin pipe with libx264 crf18
  (matching the reference's output quality), falling back to cv2 mp4v when no
  ffmpeg binary is present;
* all frames are BGR uint8 HxWx3, the universal host-side format.
"""

from __future__ import annotations

import os
import queue
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import cv2
import numpy as np

from vsr_tpu_torch.io.ffmpeg import find_ffmpeg


@dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    frame_count: int

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)


def read_video_info(path: str) -> VideoInfo:
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        return VideoInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) + 0.5),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) + 0.5),
            fps=float(cap.get(cv2.CAP_PROP_FPS)),
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT) + 0.5),
        )
    finally:
        cap.release()


class VideoReader:
    """Sequential BGR frame reader over cv2.VideoCapture."""

    def __init__(self, path: str):
        self.path = path
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.info = VideoInfo(
            width=int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH) + 0.5),
            height=int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT) + 0.5),
            fps=float(self.cap.get(cv2.CAP_PROP_FPS)),
            frame_count=int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT) + 0.5),
        )

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        return self.cap.read()

    def release(self) -> None:
        self.cap.release()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ok, frame = self.read()
            if not ok:
                return
            yield frame


class FramePrefetcher:
    """Daemon thread that pre-decodes frames into a bounded queue.

    cv2.VideoCapture-compatible read()/release() interface (as in
    backend/tools/video_io.py:12-51), so inpainter wrappers can consume either
    a raw reader or a prefetcher interchangeably.
    """

    def __init__(self, reader, buffer_size: int = 16):
        self._reader = reader
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stopped.is_set():
            ok, frame = self._reader.read()
            try:
                self._queue.put((ok, frame), timeout=1.0)
            except queue.Full:
                if self._stopped.is_set():
                    return
                # retry; consumer may just be slow
                while not self._stopped.is_set():
                    try:
                        self._queue.put((ok, frame), timeout=1.0)
                        break
                    except queue.Full:
                        continue
            if not ok:
                return

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        return self._queue.get()

    def stop(self) -> None:
        self._stopped.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def release(self) -> None:
        self.stop()
        self._reader.release()


class VideoWriter:
    """BGR frame sink: ffmpeg libx264 pipe when available, else cv2 mp4v.

    The ffmpeg path mirrors the reference writer's settings
    (backend/tools/video_io.py:62-77): rawvideo bgr24 stdin, libx264,
    yuv420p, crf/preset configurable.
    """

    def __init__(
        self,
        path: str,
        fps: float,
        size: Tuple[int, int],
        crf: int = 18,
        preset: str = "fast",
        force_cv2: bool = False,
    ):
        self.path = path
        self.size = size
        self._proc: Optional[subprocess.Popen] = None
        self._cv2_writer: Optional[cv2.VideoWriter] = None
        self._frames_written = 0
        self._stderr_file = None
        ffmpeg = None if force_cv2 else find_ffmpeg()
        if ffmpeg:
            w, h = size
            cmd = [
                ffmpeg, "-y",
                "-f", "rawvideo", "-vcodec", "rawvideo",
                "-s", f"{w}x{h}", "-pix_fmt", "bgr24", "-r", str(fps),
                "-i", "-",
                "-c:v", "libx264", "-pix_fmt", "yuv420p",
                "-crf", str(crf), "-preset", preset,
                "-loglevel", "error", path,
            ]
            self._stderr_file = tempfile.TemporaryFile()
            self._proc = subprocess.Popen(
                cmd,
                stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL,
                stderr=self._stderr_file,
            )
        else:
            self._cv2_writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size
            )
            if not self._cv2_writer.isOpened():
                raise IOError(f"cannot open video writer: {path}")

    def _encoder_error(self) -> IOError:
        detail = ""
        if self._stderr_file is not None:
            try:
                self._stderr_file.seek(0)
                detail = self._stderr_file.read().decode(
                    "utf-8", "replace").strip()
            except Exception:
                pass
        rc = self._proc.poll() if self._proc is not None else None
        return IOError(
            f"ffmpeg encoder died (returncode={rc}) after "
            f"{self._frames_written} frames writing {self.path}"
            + (f": {detail}" if detail else "")
        )

    def write(self, frame: np.ndarray) -> None:
        if frame.dtype != np.uint8:
            frame = np.clip(frame, 0, 255).astype(np.uint8)
        if self._proc is not None:
            # Encoder death must surface immediately — silently counting
            # frames would report success with a truncated file.
            try:
                self._proc.stdin.write(frame.tobytes())
            except (BrokenPipeError, OSError):
                raise self._encoder_error() from None
        else:
            self._cv2_writer.write(frame)
        self._frames_written += 1

    @property
    def frames_written(self) -> int:
        return self._frames_written

    def release(self) -> None:
        if self._proc is not None:
            broken = False
            try:
                self._proc.stdin.close()
            except (BrokenPipeError, OSError):
                broken = True
            try:
                rc = self._proc.wait(timeout=600)
            except subprocess.TimeoutExpired:
                self._proc.terminate()
                rc = self._proc.wait(timeout=5)
            if rc != 0 or broken:
                err = self._encoder_error()
                self._proc = None
                if self._stderr_file is not None:
                    self._stderr_file.close()
                    self._stderr_file = None
                raise err
            self._proc = None
        if self._stderr_file is not None:
            self._stderr_file.close()
            self._stderr_file = None
        if self._cv2_writer is not None:
            self._cv2_writer.release()
            self._cv2_writer = None


class FFmpegVideoReader:
    """Deterministic BGR frame reader over an ffmpeg rawvideo pipe.

    The cv2 reader depends on the build's codec plugins; the ffmpeg pipe
    gives bit-identical decodes across machines (SURVEY §7 step 2). Requires
    an ffmpeg binary (vsr_tpu_torch.io.ffmpeg.find_ffmpeg) — callers fall
    back to VideoReader when unavailable. read()/release() interface matches
    cv2.VideoCapture.
    """

    def __init__(self, path: str):
        ffmpeg = find_ffmpeg()
        if ffmpeg is None:
            raise RuntimeError("ffmpeg binary not found")
        self.path = path
        self.info = read_video_info(path)
        self._frame_bytes = self.info.width * self.info.height * 3
        self._proc = subprocess.Popen(
            [ffmpeg, "-i", path, "-f", "rawvideo", "-pix_fmt", "bgr24",
             "-loglevel", "error", "-"],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            bufsize=self._frame_bytes * 4,
        )

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        buf = self._proc.stdout.read(self._frame_bytes)
        if buf is None or len(buf) < self._frame_bytes:
            return False, None
        frame = np.frombuffer(buf, np.uint8).reshape(
            self.info.height, self.info.width, 3)
        return True, frame.copy()

    def release(self) -> None:
        try:
            self._proc.stdout.close()
        except Exception:
            pass
        self._proc.terminate()
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self._proc.kill()


def open_reader(path: str, prefer_ffmpeg: bool = False):
    """Best decoder available: ffmpeg pipe when requested and present."""
    if prefer_ffmpeg and find_ffmpeg() is not None:
        return FFmpegVideoReader(path)
    return VideoReader(path)


def read_all_frames(path: str) -> list:
    """Read every frame of a (short) video into a list of BGR arrays."""
    reader = VideoReader(path)
    frames = list(iter(reader))
    reader.release()
    return frames
