"""The port's bench scripts (scripts/bench_modes_torch.py,
bench_parity_torch.py) against the JAX package's (scripts/bench_modes.py,
bench_parity.py): the same inputs, the same helpers, and one CPU run of
bench_parity_torch's config 2 end to end. Every script is loaded by path;
the JAX scripts' module level imports only numpy, cv2 and the standard
library."""

import importlib.util
import json
import os
import subprocess
import sys

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath):
    name = "_bench_" + os.path.basename(relpath)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return {name: _load(path) for name, path in (
        ("modes", "scripts/bench_modes.py"), ("modes_torch", "scripts/bench_modes_torch.py"),
        ("parity", "bench_parity.py"), ("parity_torch", "bench_parity_torch.py"))}


def test_bench_modes_geometry_and_frames_equal(scripts):
    jax_side, port = scripts["modes"], scripts["modes_torch"]
    assert (port.W, port.H, port.BAND) == (jax_side.W, jax_side.H, jax_side.BAND)
    assert port.MODE_FRAMES == jax_side.MODE_FRAMES
    for a, b in zip(port.make_frames(3), jax_side.make_frames(3)):
        np.testing.assert_array_equal(a, b)


def test_stub_detector_equals_bench_parity(scripts):
    jax_side, port = scripts["parity"], scripts["parity_torch"]
    box = (10, 90, 50, 60)
    for total in (1, 5, 16):
        a, b = port.StubDetector(box, total), jax_side.StubDetector(box, total)
        assert a.find_subtitle_frame_no() == b.find_subtitle_frame_no()
        assert a.detect_subtitle(None) == b.detect_subtitle(None)


def test_video_stats_and_trim_equal_bench_parity(scripts, tmp_path):
    """A tiny clip: trim_video's frames and video_stats' count and PSNR are
    the JAX script's."""
    jax_side, port = scripts["parity"], scripts["parity_torch"]
    src = str(tmp_path / "src.mp4")
    port.synthetic_video(src, 12)
    results = []
    for side in (port, jax_side):
        clip, out = str(tmp_path / f"{side.__name__}_clip.mp4"), str(tmp_path / "out.mp4")
        n = side.trim_video(src, clip, 11, scale=0.25)
        cap = cv2.VideoCapture(clip)
        size = (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        # an "output": the clip with one band blurred
        cap, frames = cv2.VideoCapture(clip), []
        ok, frame = cap.read()
        while ok:
            frame[200:240] = cv2.blur(frame[200:240], (9, 9))
            frames.append(frame)
            ok, frame = cap.read()
        cap.release()
        writer = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (frames[0].shape[1], frames[0].shape[0]))
        for frame in frames:
            writer.write(frame)
        writer.release()
        results.append((n, size, side.video_stats(clip, out)))
    assert results[0] == results[1]
    assert results[0][0] == 11 and results[0][1] == (480.0, 256.0)
    assert results[0][2][0] == 11 and np.isfinite(results[0][2][1])


# Runs a script as its own __main__, as `python SCRIPT ARGS...` would, with
# sttn-auto's STTN narrowed (tests/torch_narrow.py).
NARROW_STTN_MAIN = """
import os, runpy, sys
script = sys.argv[1]
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(script))
from tests.torch_narrow import narrow_sttn
narrow_sttn()
runpy.run_path(script, run_name="__main__")
"""


def test_bench_parity_torch_smoke_config2(tmp_path):
    """`bench_parity_torch.py --smoke --skip 1,3,4,5,6`: config 2 (sttn-auto,
    user band) on the CPU writes every frame and exits 0 (the script in a
    process of its own, with the narrow STTN: NARROW_STTN_MAIN)."""
    out = tmp_path / "results.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", NARROW_STTN_MAIN, os.path.join(REPO, "bench_parity_torch.py"),
         "--smoke", "--skip", "1,3,4,5,6", "--out", str(out)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (entry,) = json.loads(out.read_text())
    assert entry["config"] == "config2" and entry["status"] == "ok", entry
    assert entry["frames"] == 8  # frames in (--smoke: 8) == frames out
    assert "clip: 8 frames" in proc.stdout and "device cpu" in proc.stdout
