"""The ProPainter family (``drivers/propainter.py``, ``reference/propainter.py``,
``weights_propainter.py``, ``counts_propainter.py``, ``pp_spans.py`` and the
five ``pp_*`` metrics) through ``harness.run_cell`` on the CPU, in a copy
of the benchmark whose ProPainter configuration and traffic are cut to run
in seconds (narrow networks, 2 RAFT levels, 12-frame clips of 96x344
frames, float32):

* the plain run is correct, with no frame failed and no kernel launched;
* a fault planted in the program (one frame of each clip inverted, or the
  forward-backward consistency gate inverted) and the float8 control are
  not correct;
* every new metric reads None off a card, and reads the spans of the run
  when a card is stood in;
* the model FLOPs counted piece by piece equal a count of the whole
  schedule, and the published clip's count is pinned."""

import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts_propainter, harness, pp_spans
from perfbench.reference import propainter as ref
from perfbench.tests.conftest import ROOT, copy_benchmark, edit_json

CELL = "propainter.clip70_1080p"
SEED = 2**33 + 7
TINY = {"dtype": "float32", "clip_frames": 12, "calibration_hw": [64, 128],
        "reference_pair_chunk": 4,
        "raft": {"hidden": 32, "context": 32, "corr_levels": 2, "corr_radius": 4, "iters": 2,
                 "dtype": "float32"},
        "generator": {"channel": 16, "hidden": 32, "depths": 2, "heads": 2,
                      "window_size": [3, 4], "pool_size": [2, 2],
                      "soft_split": {"kernel": [7, 7], "stride": [3, 3], "padding": [3, 3]}},
        # float32 against the float32 reference reads a widest gap of 1 and a
        # mean of 0.027 here (truncation to uint8); a fault 100+ and 5+
        "limits": {"max_gap_u8": 2, "mean_gap_u8": 0.1, "outside_changed_px": 0,
                   "unit_mismatch": 0}}
METRICS = ("pp_flows_ms_per_frame", "pp_completion_ms_per_frame",
           "pp_propagation_ms_per_frame", "pp_sweep_ms_per_frame", "pp_host_ms_per_frame")


@pytest.fixture
def pp_root(tmp_path):
    root = copy_benchmark(str(tmp_path))
    edit_json(os.path.join(root, "perfbench", "configs", "propainter.json"), **TINY)
    edit_json(os.path.join(root, "perfbench", "traffic", "band_1080p.json"), width=344,
              height=96, pool_frames=30)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    yield root
    torch.set_num_threads(threads)


def invert_first_frame(driver):
    program = driver.program

    def faulty(frames, mask):
        out = program(frames, mask)
        out[0] = 255 - out[0]
        return out

    driver.program = faulty


def invert_gate(driver):
    from vsr_tpu_torch.models.propainter import generator

    check = generator.fb_consistency_check
    driver.restore = lambda: setattr(generator, "fb_consistency_check", check)
    generator.fb_consistency_check = lambda *a, **k: 1 - check(*a, **k)


def control(driver):
    driver_module = harness.load_module(os.path.join(ROOT, "perfbench", "drivers",
                                                     "propainter.py"))
    driver_module.install_control(driver)


@pytest.mark.parametrize("fault", [None, invert_first_frame, invert_gate, control])
def test_cell_runs_and_a_fault_fails_it(pp_root, fault):
    hooked = []

    def before(driver):
        hooked.append(driver)
        fault(driver)

    try:
        result = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", root=pp_root,
                                  before_window=fault and before)
    finally:
        for driver in hooked:
            getattr(driver, "restore", lambda: None)()
    assert result["attempted"] == 12 and result["failed"] == 0
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert result["kernel_launches"] == {"counted": 0, "expected": 0}
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert checks["unit_mismatch"] == 0
    if fault is None:
        assert result["correct"], checks
        assert checks["outside_changed_px"] == 0
    else:
        assert not result["correct"], checks
        assert checks["mean_gap_u8"] > TINY["limits"]["mean_gap_u8"]


def test_new_metrics_none_off_a_card_and_read_spans_on_one(pp_root):
    result = harness.run_cell(CELL, SEED, 0.3, True, device="cpu", root=pp_root)
    assert result["correct"], result["checks"]
    assert not set(result["metrics"]) & set(METRICS)
    cell = harness.load_cell(CELL, pp_root)
    readers = {m: harness.metric_reader(cell, {"name": m}, True) for m in METRICS}
    # the traced window's clips were collected: a stood-in card reads the
    # host spans, and no device time (the CPU records no events)
    card = SimpleNamespace(card={"platform": "gpu"}, frames=result["attempted"])
    host = readers["pp_host_ms_per_frame"].read(card)
    assert host is not None and host > 0
    for m in METRICS[:4]:
        assert readers[m].read(card) is None
    for m, reader in readers.items():
        assert reader.read(SimpleNamespace(card={"platform": "cpu"}, frames=12)) is None
        assert reader.LAYER in ("ProPainter stages", "ProPainter host band path")
    pp_spans.reset()
    assert readers["pp_host_ms_per_frame"].read(card) is None


def test_piecewise_count_equals_the_whole_schedule():
    """clip_flops' pieces against one count of every stage and window of a
    clip on the meta device (16 frames: two sub-videos of flow completion
    with their halo)."""
    cfg = dict(TINY, subvideo_length=8, neighbor_length=4, ref_stride=3)
    T, h, w = 16, 64, 128
    meta = torch.device("meta")
    with meta:
        model = ref.ProPainter(cfg).eval()
    model = model.to(meta)
    q, gen = model.q, model.generator

    def whole():
        frames = torch.zeros((T, 3, h, w), device=meta, dtype=torch.uint8)
        _, masks, _, completed, updated, upd = ref.clip_stages(
            model, frames, torch.zeros((h, w), device=meta), cfg)
        enc = gen.encode(updated, masks, upd, q)
        for nbrs, refs in ref.clip_windows(T, cfg):
            ids, pair = nbrs + refs, nbrs[:-1]
            gen.forward_encoded(enc[ids], (completed[0][:, pair], completed[1][:, pair]),
                                masks[:, ids], upd[:, ids], len(nbrs), q, dense=True)

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref, "grid_sample", counts_propainter._shape_of_sample)
            whole()
    assert counts_propainter.clip_flops(cfg, T, h, w) == counter.get_total_flops()


def test_published_clip_count():
    with open(os.path.join(ROOT, "perfbench", "configs", "propainter.json")) as f:
        cfg = json.load(f)
    flops = counts_propainter.clip_flops(cfg, 70, 360, 1920)
    assert flops == 453406283038720
    assert counts_propainter.model_flops(cfg, [(70, 360, 1920)] * 3) == 3 * flops
