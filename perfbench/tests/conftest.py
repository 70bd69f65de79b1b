"""Fixtures of the benchmark's own tests (``python -m pytest perfbench/tests -q``).

``tiny_root`` is a copy of the benchmark whose configurations and traffic
are cut to run in seconds on the CPU (channel 32, two blocks, 320x180
frames, chunks of 10, subtitle lines of 6-16 frames), with two sttn-det
cells added on ``TEST_TIMELINES``; ``narrow`` has the port build its STTN
at that size. Whether a card is present is decided inside ``cuda_device``,
never while a module is imported.

``TEST_TIMELINES`` are subtitle timelines for the tests alone: no cell of
``BENCHMARK.json`` runs them (the sttn-det cells wait for a timeline taken
from a published source), but they drive the timeline generator and the
sttn-det driver, reference and control here."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MODEL = {"channel": 32, "blocks": 2, "dtype": "float32", "neighbor_stride": 2,
              "ref_length": 5, "chunk_frames": 10}
# float32 against the float32 reference reads a widest gap of 0-1 and a mean
# under 1e-4 here; the float8 control 37-46 and 1.7-5.5
TINY_LIMITS = {"max_gap_u8": 4, "mean_gap_u8": 0.1, "outside_changed_px": 0,
               "unit_mismatch": 0}
TINY_FRAMES = {"width": 320, "height": 180, "pool_frames": 24, "horizon_frames": 2000}
TINY_TIMELINE = {"row_height": [8, 10], "line_frames": [6, 16], "gap_frames": [3, 12]}
TIMELINE = {"generator": "subtitle_timeline", "width": 1920, "height": 1080, "pool_frames": 240,
            "row_spacing": 4, "bottom_row_ymax": 0.988, "row_height": [44, 56], "dilation": 10,
            "sample_units": 1}
# dense: lines of 40-120 frames after gaps of 4-20 (mean 80 of 92 frames
# covered); sparse: lines of 10-30 after gaps of 20-60 (20 of 60)
TEST_TIMELINES = {
    "lines_dense": dict(TIMELINE, horizon_frames=20000, lines_per_period=8, line_frames=[40, 120],
                        gap_frames=[4, 20], two_row_share=0.5, width_share=[0.25, 0.70],
                        x_centre_jitter=0.0),
    "lines_sparse": dict(TIMELINE, horizon_frames=30000, lines_per_period=16,
                         line_frames=[10, 30], gap_frames=[20, 60], two_row_share=0.25,
                         width_share=[0.10, 0.50], x_centre_jitter=0.20),
}
DET_CELLS = [f"sttn_det.{name}" for name in TEST_TIMELINES]


def copy_benchmark(dest: str) -> str:
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "perfbench"), os.path.join(dest, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


def edit_json(path: str, **changes) -> None:
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture
def tiny_root(tmp_path):
    root = copy_benchmark(str(tmp_path))
    for name in ("sttn-auto", "sttn-auto-fp32", "sttn-det"):
        edit_json(os.path.join(root, "perfbench", "configs", f"{name}.json"),
                  limits=TINY_LIMITS, **TINY_MODEL)
    edit_json(os.path.join(root, "perfbench", "traffic", "band_1080p.json"), **TINY_FRAMES)
    for name, mix in TEST_TIMELINES.items():
        with open(os.path.join(root, "perfbench", "traffic", f"{name}.json"), "w") as f:
            json.dump(dict(mix, **TINY_FRAMES, **TINY_TIMELINE), f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "sttn-det", "source": "https://github.com/researchmm/STTN",
                             "file": "perfbench/configs/sttn-det.json", "reduced": [],
                             "why": "the tests' sttn-det cells"})
    bench["workloads"] += [{"name": cell, "config": "sttn-det", "traffic": name, "chips": 1,
                            "why": "a test timeline"} for cell, name in zip(DET_CELLS,
                                                                              TEST_TIMELINES)]
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def narrow(monkeypatch):
    """The port's inpainters build their STTN at TINY_MODEL's width."""
    import torch

    from vsr_tpu_torch.inpaint import sttn_auto, sttn_det
    from vsr_tpu_torch.models.sttn import STTNGenerator

    def build(*, variant, use_kernel, apply_attention_mask=True):
        return STTNGenerator(variant=variant, use_kernel=use_kernel,
                             channel=TINY_MODEL["channel"], stack_num=TINY_MODEL["blocks"],
                             apply_attention_mask=apply_attention_mask)

    monkeypatch.setattr(sttn_auto, "STTNGenerator", build)
    monkeypatch.setattr(sttn_det, "STTNGenerator", build)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"
