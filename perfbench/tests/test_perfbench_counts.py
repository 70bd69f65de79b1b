"""counts.py against torch.utils.flop_counter on the plain reference, and
the token-attention bound against the kernel's recorded figures."""

import json
import os

import numpy as np
import pytest
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.reference import pipeline as ref
from perfbench.tests.conftest import ROOT
from perfbench.weights import make_netg, reference_model


def load_cfg(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,t", [("sttn-auto", 7), ("sttn-det", 12)])
def test_chunk_flops_match_flop_counter(name, t):
    cfg = dict(load_cfg(name), channel=16, blocks=2)
    model = reference_model(cfg).eval()
    model.load_state_dict(make_netg(cfg, 5, "cpu"))
    W, H = cfg["input_size"]
    frames = np.random.default_rng(0).integers(0, 256, (t, H, W, 3), dtype=np.uint8)
    holes = None
    if name == "sttn-det":
        holes = np.zeros((t, H, W), np.uint8)
        holes[:, H // 2:, W // 4:] = 1
    with FlopCounterMode(display=False) as fc:
        ref.inpaint_chunk(model, frames, holes, cfg["neighbor_stride"], cfg["ref_length"], "cpu")
    assert fc.get_total_flops() == counts.chunk_flops(t, cfg)


def test_full_width_chunk_flops():
    """The published widths: 643 and 734 GFLOP a frame in 50-frame chunks."""
    assert counts.chunk_flops(50, load_cfg("sttn-auto")) == 32140586188800
    assert counts.chunk_flops(50, load_cfg("sttn-det")) == 36689243258880


@pytest.mark.parametrize("N,D,bound_ms", [(5120, 960, 0.1018), (1536, 3200, 0.0305),
                                          (2304, 2880, 0.0618), (1728, 2880, 0.0348)])
def test_token_attention_bf16_bound(N, D, bound_ms):
    """The bf16 bounds of the kernel's table: 4 N^2 D at 989 TFLOP/s,
    compute-bound at all four shapes."""
    card = counts.peaks("NVIDIA H100 80GB HBM3")
    ops, nbytes = counts.token_attention_work(1, N, N, D, 2, True)
    assert ops == 4 * N * N * D
    assert nbytes == 2 * 4 * N * D + 4 * N
    assert ops / card["bf16_flops"] > nbytes / card["hbm_bytes_per_s"]
    bound = counts.token_attention_bound_s(1, N, N, D, 2, True, card)
    assert bound * 1e3 == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("N,D,bound_ms", [(5120, 960, 0.6101), (1536, 3200, 0.1830),
                                          (2304, 2880, 0.3706), (1728, 2880, 0.2085)])
def test_token_attention_fp32_bound(N, D, bound_ms):
    """The fp32 route: three TF32 products at 495 TFLOP/s."""
    card = counts.peaks("NVIDIA H100 80GB HBM3")
    bound = counts.token_attention_bound_s(1, N, N, D, 4, False, card)
    assert bound * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_unknown_card_has_no_peaks():
    assert counts.peaks("cpu") is None


@pytest.mark.parametrize("name,work,launches", [
    ("sttn-auto", [(50, 50, 1)], 160),                     # 2 scales x 8 blocks x 10 windows
    ("sttn-auto", [(50, 50, 1)] * 49 + [(10, 50, 1)], 8000),  # 2460 frames: 8000 on the card
    ("sttn-det", [(50, 50, 1), (50, 50, 1)], 160),         # 1 scale x 8 blocks x 10 x 2
    ("sttn-det", [(12, 12, 2)], 48),                       # 3 windows in each of 2 bands
])
def test_token_attention_launches_by_schedule(name, work, launches):
    cfg = load_cfg(name)
    assert all(p in cfg["patch_sizes"] for p in cfg["kernel_patch_sizes"])
    assert counts.token_attention_launches(work, cfg) == launches
