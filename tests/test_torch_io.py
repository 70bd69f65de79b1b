"""The port's I/O layer (vsr_tpu_torch/io/) beside vsr_tpu's: every case of
tests/test_io.py, each run on the port and held to vsr_tpu's functions on
the same synthesized clip (decoded frames bit for bit), plus the pieces
the port copied later: VideoInfo.size, VideoReader.__iter__ against read(),
VideoWriter.frames_written and force_cv2, has_ffmpeg."""

import os

import cv2
import numpy as np
import pytest

import vsr_tpu.io.video as jax_vio
from vsr_tpu.io.audio import merge_audio_to_video as jax_merge_audio
from vsr_tpu.io.ffmpeg import has_ffmpeg as jax_has_ffmpeg
import vsr_tpu_torch.io.video as vio
from vsr_tpu_torch.io.audio import merge_audio_to_video
from vsr_tpu_torch.io.ffmpeg import find_ffmpeg, has_ffmpeg
from vsr_tpu_torch.io.video import (
    FFmpegVideoReader,
    FramePrefetcher,
    VideoReader,
    VideoWriter,
    open_reader,
    read_all_frames,
    read_video_info,
)


@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    """Synthesize a 32-frame 160x120 gradient video (tests/test_io.py's)."""
    path = str(tmp_path_factory.mktemp("vid") / "tiny.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (160, 120))
    for i in range(32):
        frame = np.full((120, 160, 3), i * 8 % 256, np.uint8)
        frame[:, :40, 0] = 255
        w.write(frame)
    w.release()
    return path


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_video_info(tiny_video):
    info = read_video_info(tiny_video)
    assert (info.width, info.height) == (160, 120)
    assert info.frame_count == 32
    assert info.fps == pytest.approx(25, abs=0.5)
    assert info.size == (160, 120)
    assert info == vio.VideoInfo(**vars(jax_vio.read_video_info(tiny_video)))
    assert info.size == jax_vio.read_video_info(tiny_video).size


def test_reader_reads_all(tiny_video):
    frames = read_all_frames(tiny_video)
    assert len(frames) == 32
    assert frames[0].shape == (120, 160, 3)
    assert frames[0].dtype == np.uint8
    _assert_frames_equal(frames, jax_vio.read_all_frames(tiny_video))


def test_reader_iter_matches_read(tiny_video):
    reader = VideoReader(tiny_video)
    assert reader.info == read_video_info(tiny_video)
    by_iter = list(reader)
    reader.release()
    reader, by_read = VideoReader(tiny_video), []
    while True:
        ok, frame = reader.read()
        if not ok:
            break
        by_read.append(frame)
    reader.release()
    _assert_frames_equal(by_iter, by_read)
    jax_reader = jax_vio.VideoReader(tiny_video)
    _assert_frames_equal(by_iter, list(jax_reader))
    jax_reader.release()


def test_prefetcher_matches_reader(tiny_video):
    direct = jax_vio.read_all_frames(tiny_video)
    pf = FramePrefetcher(VideoReader(tiny_video), buffer_size=4)
    fetched = []
    while True:
        ok, frame = pf.read()
        if not ok:
            break
        fetched.append(frame)
    pf.release()
    _assert_frames_equal(fetched, direct)


def test_prefetcher_early_stop(tiny_video):
    pf = FramePrefetcher(VideoReader(tiny_video), buffer_size=2)
    ok, _ = pf.read()
    assert ok
    pf.release()  # must not hang with a full queue


@pytest.mark.parametrize("force_cv2", [False, True])
def test_writer_round_trip(tmp_path, tiny_video, force_cv2):
    """The port's writer (ffmpeg when present, or forced to cv2) and
    vsr_tpu's with the same arguments: the same count, the same gross
    structure; with cv2 on both sides, the same decoded frames."""
    frames = read_all_frames(tiny_video)
    outs = []
    for name, writer_cls in (("port", VideoWriter), ("jax", jax_vio.VideoWriter)):
        out = str(tmp_path / f"{name}.mp4")
        writer = writer_cls(out, 25, (160, 120), force_cv2=force_cv2)
        for f in frames:
            writer.write(f)
        writer.release()
        assert writer.frames_written == 32
        outs.append(out)
    back = read_all_frames(outs[0])
    assert len(back) == 32
    # lossy codec: just check gross structure survived
    assert np.abs(back[5].astype(int) - frames[5].astype(int)).mean() < 16
    if force_cv2 or not has_ffmpeg():
        _assert_frames_equal(back, jax_vio.read_all_frames(outs[1]))


def test_writer_force_cv2_skips_ffmpeg(tmp_path, monkeypatch):
    """force_cv2 writes through cv2 even when an ffmpeg binary is found:
    here a fake one that would fail every write."""
    fake = _fake_ffmpeg(tmp_path, "exit 1")
    monkeypatch.setattr(vio, "find_ffmpeg", lambda: fake)
    out = str(tmp_path / "cv2.mp4")
    writer = VideoWriter(out, 25, (64, 48), force_cv2=True)
    for i in range(3):
        writer.write(np.full((48, 64, 3), 40 * i, np.uint8))
    writer.release()
    assert writer.frames_written == 3
    assert len(read_all_frames(out)) == 3


def test_writer_accepts_float_frames(tmp_path):
    out = str(tmp_path / "f.mp4")
    writer = VideoWriter(out, 25, (64, 48), force_cv2=True)
    writer.write(np.full((48, 64, 3), 300.0))  # clipped to 255
    writer.release()
    assert os.path.getsize(out) > 0
    assert writer.frames_written == 1
    (frame,) = read_all_frames(out)
    assert frame.min() >= 250  # 255 after the codec


def _fake_ffmpeg(tmp_path, script_body: str) -> str:
    fake = tmp_path / "fake_ffmpeg"
    fake.write_text(f"#!/bin/sh\n{script_body}\n")
    fake.chmod(0o755)
    return str(fake)


def test_writer_raises_when_encoder_dies_midstream(tmp_path, monkeypatch):
    """An encoder that dies mid-run must surface as an error, not a silently
    truncated file."""
    fake = _fake_ffmpeg(tmp_path, "head -c 1000 > /dev/null\nexit 1")
    monkeypatch.setattr(vio, "find_ffmpeg", lambda: fake)
    writer = VideoWriter(str(tmp_path / "dead.mp4"), 25, (64, 48))
    frame = np.zeros((48, 64, 3), np.uint8)
    with pytest.raises(IOError, match="ffmpeg encoder died"):
        for _ in range(300):  # >> pipe buffer, forces EPIPE
            writer.write(frame)
        writer.release()


def test_writer_release_checks_returncode(tmp_path, monkeypatch):
    fake = _fake_ffmpeg(tmp_path, "cat > /dev/null\nexit 3")
    monkeypatch.setattr(vio, "find_ffmpeg", lambda: fake)
    writer = VideoWriter(str(tmp_path / "rc.mp4"), 25, (64, 48))
    writer.write(np.zeros((48, 64, 3), np.uint8))
    assert writer.frames_written == 1
    with pytest.raises(IOError, match="returncode=3"):
        writer.release()


def test_audio_merge_falls_back_without_audio(tmp_path, tiny_video):
    # tiny_video has no audio stream; with or without ffmpeg the call must
    # produce the output and report merged=False, as vsr_tpu's does.
    out = str(tmp_path / "merged.mp4")
    merged = merge_audio_to_video(tiny_video, tiny_video, out)
    assert os.path.exists(out)
    assert merged is False
    assert jax_merge_audio(tiny_video, tiny_video, str(tmp_path / "jax.mp4")) is merged


def test_ffmpeg_reader_gated(tiny_video):
    """FFmpegVideoReader matches cv2 decode when ffmpeg exists; otherwise the
    factory falls back cleanly."""
    assert has_ffmpeg() == (find_ffmpeg() is not None) == jax_has_ffmpeg()
    reader = open_reader(tiny_video, prefer_ffmpeg=True)
    if find_ffmpeg() is None:
        assert isinstance(reader, VideoReader)
        reader.release()
        with pytest.raises(RuntimeError, match="ffmpeg binary not found"):
            FFmpegVideoReader(tiny_video)
        return
    direct = read_all_frames(tiny_video)
    got = []
    while True:
        ok, f = reader.read()
        if not ok:
            break
        got.append(f)
    reader.release()
    assert len(got) == len(direct)
    assert got[0].shape == direct[0].shape


def test_open_reader_defaults_to_cv2(tiny_video):
    reader = open_reader(tiny_video)
    assert isinstance(reader, VideoReader)
    _assert_frames_equal(list(reader), jax_vio.read_all_frames(tiny_video))
    reader.release()
