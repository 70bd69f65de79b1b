"""Whole runs of the cells at a tiny size on the CPU through the harness's
functions (the look for a card is run.py's and is skipped here): a sound run
comes out correct; the timed path broken underneath, or the control in the
program's place, comes out not correct.

The faults each cell can have, planted in the port's window engine, which
both STTN modes share: a step that returns its state unchanged (the chunk's
model-size frames come back as they went in), half of the batch left out
(only the first half of a chunk is computed, the rest repeats it), and an
answer altered where it is produced (one frame of each chunk inverted). One
card holds every cell, so no exchange between cards can be left out."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import DET_CELLS, ROOT, edit_json

SEED = 2**33 + 7
CELLS = ["sttn_auto.band_1080p"] + DET_CELLS


def run(root, cell, before_window=None, seconds=1.5):
    return harness.run_cell(cell, SEED, seconds, False, device="cpu", root=root,
                            before_window=before_window)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, narrow, cell):
    result = run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"fps", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["checks"]["unit_mismatch"]["value"] == 0
    # the plain route on the CPU launches no kernel, and the schedule expects none there
    assert result["kernel_launches"] == {"counted": 0, "expected": 0}


def _unchanged(engine, frames_u8, *index, masks=None):
    r0, r1 = engine.out_rows or (0, frames_u8.shape[1])
    return frames_u8[:, r0:r1].clone()


def _plant(monkeypatch, fault):
    from vsr_tpu_torch.inpaint.engine import STTNWindowEngine

    if fault == "state_unchanged":
        monkeypatch.setattr(STTNWindowEngine, "_chunk_step", _unchanged)
        return
    if fault == "half_batch":
        dispatch, fetch = STTNWindowEngine.dispatch, STTNWindowEngine.fetch

        def half_dispatch(self, frames, masks=None):
            half = max(1, len(frames) // 2)
            return dispatch(self, frames[:half], None if masks is None else masks[:half]), len(
                frames)

        def half_fetch(self, handle):
            inner, n = handle
            out = fetch(self, inner)
            return np.concatenate([out, np.repeat(out[-1:], n - len(out), axis=0)])

        monkeypatch.setattr(STTNWindowEngine, "dispatch", half_dispatch)
        monkeypatch.setattr(STTNWindowEngine, "fetch", half_fetch)
        return
    if fault == "answer_altered":
        fetch = STTNWindowEngine.fetch

        def altered(self, handle):
            out = fetch(self, handle).copy()
            out[0] = 255 - out[0]
            return out

        monkeypatch.setattr(STTNWindowEngine, "fetch", altered)
        return
    raise ValueError(fault)


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(tiny_root, narrow, monkeypatch, cell, fault):
    _plant(monkeypatch, fault)
    result = run(tiny_root, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_control_is_not_correct(tiny_root, narrow, cell):
    """The plain reference in float8 e4m3 in the program's place."""
    cell_mod = harness.load_cell(cell, tiny_root).driver
    result = run(tiny_root, cell, before_window=cell_mod.install_control, seconds=2.0)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("dtype,correct", [("float32", True), ("bfloat16", False)])
def test_fp32_cell_fails_the_program_in_bf16(tiny_root, narrow, dtype, correct):
    """The float32 cell's control, under the configuration's own limits:
    the program's own bf16 path, the precision below the float32 the
    configuration states."""
    with open(os.path.join(ROOT, "perfbench", "configs", "sttn-auto-fp32.json")) as f:
        limits = json.load(f)["limits"]
    path = os.path.join(tiny_root, "perfbench", "configs", "sttn-auto-fp32.json")
    edit_json(path, dtype=dtype, limits=limits)
    result = run(tiny_root, "sttn_auto.fp32_band_1080p")
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == set(limits)
    assert result["correct"] == correct, result["checks"]


def test_compare_units_reads_the_gaps():
    """Gaps of 0, 1, 3 and 10 (and two of 0) inside a two-pixel mask, one
    pixel changed outside it, and a unit the reference does not form."""
    want = torch.zeros((1, 2, 2, 3), dtype=torch.uint8)
    mask = np.array([[1, 1], [0, 0]], np.uint8)
    got = np.zeros((2, 2, 3), np.uint8)
    got[0, 0], got[0, 1], got[1, 1] = [0, 1, 3], [10, 0, 0], [1, 0, 0]
    formed, unformed = harness.Unit(0, 0), harness.Unit(1, 1)
    formed.frames = unformed.frames = [got]
    readings = harness.compare_units(
        [formed, unformed], lambda u: (want, mask) if u is formed else None, "cpu")
    assert readings == {"max_gap_u8": 10, "mean_gap_u8": 14 / 6, "gap_over2_pct": 100 * 2 / 6,
                        "outside_changed_px": 1, "unit_mismatch": 1}


def test_traced_run_reads_a_window(tiny_root, narrow):
    """The traced path on the CPU: the window span is found, no device op,
    and no per-layer metric reads a number it has not got."""
    result = harness.run_cell(CELLS[0], SEED, 1.0, True, device="cpu", root=tiny_root)
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
    assert result["breakdown"]["device_ops"] == []
    assert result["correct"]


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    """The first cell, briefly, on a card (skipped without one)."""
    result = harness.run_cell(CELLS[0], SEED, 2.0, False, device=cuda_device)
    assert result["device"]["platform"] == "gpu" and result["attempted"] > 0
