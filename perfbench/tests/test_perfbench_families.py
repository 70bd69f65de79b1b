"""A model family added by new files alone: a toy family (a driver, a
configuration and a traffic file, with entries appended to BENCHMARK.json)
runs end to end through ``harness.run_cell`` on the CPU, comes out correct,
and not correct with a fault planted in its program, while no file that was
there changes. And the STTN drivers' family methods give exactly the counts
the harness read before they existed."""

import glob
import json
import os
from types import SimpleNamespace

import pytest
import torch

from perfbench import counts, harness, weights
from perfbench.tests.conftest import ROOT, copy_benchmark

SEED = 2**32 + 5

TOY_DRIVER = '''"""A toy family: a seeded 3x3 convolution that repaints the selection
area of every frame, in chunks; its program computes the convolution as an
unfold and a matmul, its reference as nn.Conv2d."""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench import generator


class Reference(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 3, 3, padding=1)

    def forward(self, x):
        return torch.tanh(self.conv(x))


def area(mix):
    xmin, xmax, ymin, ymax = generator.selection_box(mix)
    return slice(ymin, ymax), slice(xmin, xmax)


def to_u8(x):
    return ((x + 1) * 127.5).round().clamp(0, 255).to(torch.uint8)


def repaint(frames, mix, paint):
    """The frames with the selection area replaced by ``paint`` of it."""
    rows, cols = area(mix)
    out = torch.from_numpy(np.stack(frames)).clone()
    x = out[:, rows, cols].permute(0, 3, 1, 2).float() / 127.5 - 1
    out[:, rows, cols] = to_u8(paint(x)).permute(0, 2, 3, 1)
    return out


class Driver:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.frame_shape = (mix["height"], mix["width"], 3)
        self.pool = generator.frame_pool(mix, seed, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        w = torch.randn((3, 3, 3, 3), generator=gen, device=device) / math.sqrt(27)
        b = torch.randn((3,), generator=gen, device=device) * 0.02
        self.netg = {"conv.weight": w, "conv.bias": b}
        self.chunk = cfg["chunk_frames"]
        self.program = self._program

    def _program(self, frames):
        w, b = self.netg["conv.weight"], self.netg["conv.bias"]

        def paint(x):
            n, _, h, wd = x.shape
            cols = F.unfold(x, 3, padding=1)
            return torch.tanh((w.reshape(3, -1) @ cols + b[:, None]).reshape(n, 3, h, wd))

        return list(repaint(frames, self.mix, paint).numpy())

    def unit_of(self, index):
        return index // self.chunk

    def warm(self):
        self.program(self.pool[:self.chunk])

    def window(self, reader, writer):
        while True:
            chunk = []
            while len(chunk) < self.chunk:
                ok, frame = reader.read()
                if not ok:
                    break
                chunk.append(frame)
            for frame in self.program(chunk) if chunk else ():
                writer.write(frame)
            if len(chunk) < self.chunk:
                return reader.taken

    def chunk_work(self, taken):
        rows, cols = area(self.mix)
        pixels = (rows.stop - rows.start) * (cols.stop - cols.start)
        return [(min(self.chunk, taken - s), pixels) for s in range(0, taken, self.chunk)]

    def launches(self):
        return 0

    def host_spans(self):
        return []

    def free(self):
        self.program = None

    @staticmethod
    def reference_unit(cfg, mix, seed, pool, model, first, length, taken, device):
        chunk = cfg["chunk_frames"]
        if first % chunk or length != min(chunk, taken - first):
            return None
        mask = np.zeros((mix["height"], mix["width"]), np.uint8)
        mask[area(mix)] = 1
        frames = [pool[i % len(pool)] for i in range(first, first + length)]
        with torch.no_grad():
            return repaint(frames, mix, model).to(device), mask

    @staticmethod
    def reference_model(cfg, quant="float32"):
        return Reference()

    @staticmethod
    def expected_launches(cfg, work):
        return 0

    @staticmethod
    def model_flops(cfg, work):
        return sum(2 * 27 * 3 * frames * pixels for frames, pixels in work)
'''

TOY_CONFIG = {"name": "toy", "driver": "toy", "dtype": "float32", "chunk_frames": 4,
              "reduced": [],
              "limits": {"max_gap_u8": 2, "mean_gap_u8": 0.05, "outside_changed_px": 0,
                         "unit_mismatch": 0}}
TOY_TRAFFIC = {"generator": "band_stream", "width": 64, "height": 48, "pool_frames": 10,
               "selection_area": [0.5, 0.9, 0.1, 0.9], "dilation": 0, "sample_units": 2}
# the toy's work per frame: a 3x3 convolution, 3 channels in and out, over
# the 19 x 51 pixels of the selection area
TOY_FLOPS_PER_FRAME = 2 * 27 * 3 * 19 * 51
# a per-layer metric that reads what the harness gives the metrics as the
# model FLOPs, so the run shows that the count is the driver's
FLOPS_METRIC = ("LAYER = 'model step'\nUNIT = 'FLOP'\nMOVES = 'fps'\n\n\n"
                "def read(ctx):\n    return ctx.model_flops\n")


def snapshot(root):
    """The benchmark's files under ``root/perfbench``, by path."""
    paths = glob.glob(os.path.join(root, "perfbench", "**", "*"), recursive=True)
    return {p: open(p, "rb").read() for p in paths if os.path.isfile(p)}


@pytest.fixture
def toy_root(tmp_path):
    root = copy_benchmark(str(tmp_path))
    before = snapshot(root)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "drivers", "toy.py"), "w") as f:
        f.write(TOY_DRIVER)
    with open(os.path.join(pb, "configs", "toy.json"), "w") as f:
        json.dump(TOY_CONFIG, f)
    with open(os.path.join(pb, "traffic", "toy_stream.json"), "w") as f:
        json.dump(TOY_TRAFFIC, f)
    with open(os.path.join(pb, "metrics", "toy_model_flops.py"), "w") as f:
        f.write(FLOPS_METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy", "source": "a test", "reduced": [],
                             "file": "perfbench/configs/toy.json", "why": "a toy family"})
    bench["workloads"].append({"name": "toy.stream", "config": "toy", "traffic": "toy_stream",
                               "chips": 1, "why": "a toy cell"})
    bench["per_layer"].append({"name": "toy_model_flops", "unit": "FLOP", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "fps"})
    with open(path, "w") as f:
        json.dump(bench, f)
    yield root
    after = snapshot(root)
    for p, data in before.items():
        assert after.get(p) == data, p
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        old = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(old[key])] == old[key]  # entries only appended


def invert_first_frame(driver):
    """The fault: one frame of each chunk inverted where it is produced."""
    program = driver.program

    def faulty(frames):
        out = program(frames)
        out[0] = 255 - out[0]
        return out

    driver.program = faulty


@pytest.mark.parametrize("fault", [None, invert_first_frame])
def test_toy_family_runs_from_new_files(toy_root, fault):
    result = harness.run_cell("toy.stream", SEED, 0.3, False, device="cpu", root=toy_root,
                              before_window=fault)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert result["kernel_launches"] == {"counted": 0, "expected": 0}
    if fault is None:
        assert result["correct"], result["checks"]
        assert result["checks"]["unit_mismatch"]["value"] == 0
    else:
        assert not result["correct"], result["checks"]
        assert result["checks"]["max_gap_u8"]["value"] > TOY_CONFIG["limits"]["max_gap_u8"]


def test_toy_family_model_flops_reach_the_metrics(toy_root):
    """A traced run on the CPU hands the metrics the toy driver's count;
    mfu_pct reads it against the card's peak through a stub context."""
    result = harness.run_cell("toy.stream", SEED, 0.3, True, device="cpu", root=toy_root)
    assert result["correct"], result["checks"]
    flops = result["metrics"]["toy_model_flops"]["value"]
    assert flops == result["attempted"] * TOY_FLOPS_PER_FRAME
    cell = harness.load_cell("toy.stream", toy_root)
    mfu = harness.metric_reader(cell, {"name": "mfu_pct"}, True)
    card = counts.peaks("NVIDIA H100 80GB HBM3")
    ctx = SimpleNamespace(card={"kind": "NVIDIA H100 80GB HBM3"}, model_flops=flops,
                          trace=SimpleNamespace(window_s=0.5))
    assert mfu.read(ctx) == pytest.approx(100.0 * flops / (0.5 * card["bf16_flops"]))
    assert mfu.read(SimpleNamespace(**dict(vars(ctx), card={"kind": "cpu"}))) is None
    assert mfu.read(SimpleNamespace(**dict(vars(ctx), model_flops=None))) is None


def load_cfg(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,work", [
    ("sttn-auto", [(50, 50, 1)]),
    ("sttn-auto", [(50, 50, 1)] * 49 + [(10, 50, 1)]),
    ("sttn-auto-fp32", [(50, 50, 1)] * 49 + [(10, 50, 1)]),
    ("sttn-det", [(50, 50, 1), (50, 50, 1)]),
    ("sttn-det", [(12, 12, 2)]),
])
def test_sttn_family_methods_count_as_before(name, work):
    """The work tuples of test_perfbench_counts.py: each STTN driver's
    counts are counts.py's, and its reference is weights.py's."""
    cfg = load_cfg(name)
    family = harness.load_module(
        os.path.join(ROOT, "perfbench", "drivers", f"{cfg['driver']}.py")).Driver
    assert family.expected_launches(cfg, work) == counts.token_attention_launches(work, cfg)
    assert family.model_flops(cfg, work) == sum(
        bands * counts.chunk_flops(frames, cfg) for frames, _, bands in work)
    pinned = {"sttn-auto": 32140586188800, "sttn-auto-fp32": 32140586188800,
              "sttn-det": 36689243258880}[name]
    assert family.model_flops(cfg, [(50, 50, 1)]) == pinned
    with torch.device("meta"):
        got, want = family.reference_model(cfg, "fp8_e4m3"), weights.reference_model(cfg)
    assert type(got) is type(want)
    assert {k: v.shape for k, v in got.state_dict().items()} == {
        k: v.shape for k, v in want.state_dict().items()}
