"""The port's ProPainter (vsr_tpu_torch/inpaint/propainter.py) against the
benchmark's plain reference (perfbench/reference/propainter.py), written
from the published sources, on the CPU in float32 with narrow seeded
networks: the weights come from perfbench/weights_propainter.py, are
written as the three published checkpoints and reach the port through its
``prepare_models`` converter, as in the benchmark.

* RAFT flows, completed flows and propagated frames, stage by stage, on
  16 frames of 64x128;
* the whole ``__call__`` on 10 frames of 72x216 (one 40x216 band), under a
  short schedule (sub-videos of 6 flows, windows every 2 frames, global
  references every 3) so that the halo chunks and the limited reference
  count run;
* the same check fails the port computing in bf16, and the port with a
  planted fault: one window's references dropped, or the consistency gate
  inverted;
* the reference imports neither jax nor vsr_tpu_torch.

RAFT runs 2 correlation levels here (the published 4 need bands of 64 rows
and more): upstream's bilinear sampler divides by (H - 1), so a pyramid
level one row high is not defined there.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import propainter as ref
from perfbench.weights_propainter import make_weights, write_checkpoints
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint import propainter as pp
from vsr_tpu_torch.masks.mask import create_mask
from vsr_tpu_torch.models.propainter import generator as pp_generator
from vsr_tpu_torch.prepare import prepare_models

REPO = Path(__file__).resolve().parent.parent
SEED = 2**32 + 20
CFG = {"raft": {"hidden": 32, "context": 32, "corr_levels": 2, "corr_radius": 4, "iters": 2},
       "generator": {"channel": 16, "hidden": 32, "depths": 2, "heads": 2,
                     "window_size": [3, 4], "pool_size": [2, 2],
                     "soft_split": {"kernel": [7, 7], "stride": [3, 3], "padding": [3, 3]}},
       "subvideo_length": 6, "neighbor_length": 4, "ref_stride": 3, "mask_dilation": 4,
       "band_height_of_width": [3, 16], "reference_pair_chunk": 5, "calibration_hw": [64, 128]}
# float32 against float32, the same seeded weights: the flows part by
# 1-6e-5 px over RAFT's iterations (the port's gather lookup against the
# reference's grid_sample, sums in another order); 1e-3 px leaves room
FLOW_PX = 1e-3
# the whole __call__ in uint8: the prediction is truncated to uint8, so a
# rounding difference of 1e-6 moves a value by 1 where it sits on an
# integer; the port's LayerNorm eps (1e-6, flax's) against upstream's
# (1e-5) moves values by ~1e-5. Measured: widest 1, mean 0.059; a planted
# fault reads 14-123 and 0.93-6.3.
MAX_U8, MEAN_U8 = 1, 0.1


@pytest.fixture(scope="module")
def weights():
    state = make_weights(CFG, SEED, "cpu")
    model = ref.ProPainter(CFG).eval()
    model.load_state_dict(state, strict=True)
    return state, model


def port_inpainter(state, tmp, dtype="float32"):
    src = os.path.join(tmp, "models")
    os.makedirs(os.path.join(src, "propainter"), exist_ok=True)
    write_checkpoints(state, os.path.join(src, "propainter"))
    out = os.path.join(tmp, "npz")
    status = prepare_models(src, out, families=["raft", "flow-completion", "propainter"],
                            log=lambda _: None, check_fn=lambda *_: None)
    assert set(status.values()) == {"converted"}, status
    g, r = CFG["generator"], CFG["raft"]
    config = Config(compute_dtype=dtype, propainter_raft_iters=r["iters"],
                    propainter_subvideo_length=CFG["subvideo_length"],
                    propainter_neighbor_length=CFG["neighbor_length"],
                    propainter_ref_stride=CFG["ref_stride"])
    return pp.PropainterInpainter(
        out, config, dict(channel=g["channel"], hidden=g["hidden"], depths=g["depths"],
                          n_head=g["heads"], window_size=g["window_size"],
                          pool_size=g["pool_size"]),
        dict(hidden=r["hidden"], context=r["context"], corr_levels=r["corr_levels"],
             corr_radius=r["corr_radius"]), device="cpu")


@pytest.fixture(scope="module")
def port(weights, tmp_path_factory):
    return port_inpainter(weights[0], str(tmp_path_factory.mktemp("pp")))


def frames_u8(n, h, w, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8, generator=gen)


@pytest.fixture(scope="module")
def stages(weights):
    """The reference's stages on 16 frames of 64x128 under a box."""
    frames = frames_u8(16, 64, 128, 1)
    hole = torch.zeros(64, 128)
    hole[30:50, 20:100] = 1
    rgb = frames.flip(-1).permute(0, 3, 1, 2).contiguous()
    return rgb, hole, ref.clip_stages(weights[1], rgb, hole, CFG)


def test_raft_flows_match(port, stages):
    rgb, _, (_, _, flows, _, _, _) = stages
    with torch.inference_mode():
        got = port._compute_flows(rgb.float() / 255.0 * 2.0 - 1.0)
    assert float(flows[0].abs().max()) > 5  # calibrated flows of pixels, not nothing
    for a, b in zip(got, flows):
        assert float((a - b[0]).abs().max()) < FLOW_PX


def test_completed_flows_match(port, stages):
    """From the reference's flows, so the stage is compared alone."""
    _, _, (_, masks, flows, completed, _, _) = stages
    with torch.inference_mode():
        got = port._complete_flows(flows[0][0], flows[1][0], masks[0])
    for a, b in zip(got, completed):
        assert float((a - b[0]).abs().max()) < FLOW_PX


@pytest.mark.parametrize("flows", ["completed", "consistent"])
def test_propagated_frames_match(flows, port, weights, stages):
    """From the reference's completed flows (seeded noise frames: the
    forward-backward check passes almost nowhere) and from smooth flows
    whose backward is the forward's negative (it passes, and the hole
    fills from the frames around). The warps sample nearest and the gates
    compare: exact, where no sample sits within float rounding of a .5
    boundary (the smooth flows keep 0.2 px from one) or of a threshold."""
    rgb, _, (frames, masks, _, completed, updated, updated_masks) = stages
    if flows == "consistent":
        T, _, h, w = frames.shape[1:]
        xs = torch.arange(w).float()
        fw = torch.zeros(1, T - 1, 2, h, w)
        fw[:, :, 0] = 6.3 + 0.2 * torch.sin(xs / 9)
        fw[:, :, 1] = 1.7
        completed = (fw, -fw)
        updated, updated_masks = ref.propagate_images(weights[1], frames, masks, completed, CFG)
        assert float((masks - updated_masks).sum()) > 0  # the hole partly filled
    with torch.inference_mode():
        got, got_masks = port._propagate_images(frames[0], masks[0], completed[0][0],
                                                completed[1][0])
    assert torch.equal(got_masks, updated_masks[0])
    assert float((got - updated[0]).abs().max()) < 1e-6


def call_frames():
    """10 frames of 72x216 and the tool's default selection as a mask."""
    frames = [f.numpy() for f in frames_u8(10, 72, 216, 2)]
    box = (int(0.15 * 216), int(0.85 * 216), int(0.88 * 72), int(0.99 * 72))
    return frames, create_mask((72, 216), [box], 10)


@pytest.fixture(scope="module")
def reference_call(weights):
    frames, mask = call_frames()
    out, region = ref.propainter(weights[1], frames, mask, CFG, "cpu")
    return frames, mask, out.numpy(), region


def gaps(got, want, region):
    """(widest, mean) uint8 gap inside ``region``; pixels changed outside it."""
    diff = np.abs(np.stack(got).astype(int) - want.astype(int))
    outside = int((diff.max(axis=-1) > 0)[:, ~region].sum())
    return int(diff.max()), float(diff[:, region].mean()), outside


def test_call_matches_reference(port, reference_call):
    frames, mask, want, region = reference_call
    assert region.sum() > 0 and (np.stack(frames) != want).any()
    widest, mean, outside = gaps(port([f.copy() for f in frames], mask), want, region)
    assert outside == 0
    assert widest <= MAX_U8 and mean <= MEAN_U8, (widest, mean)


def drop_one_window_refs(monkeypatch):
    """The window at frame 4, the first with a global reference (frame 1),
    loses it."""
    def one_without(mid, neighbor_ids, length, ref_stride=10, ref_num=-1):
        got = ref.get_ref_index(mid, neighbor_ids, length, ref_stride, ref_num)
        return [] if mid == 4 else got

    monkeypatch.setattr(pp, "get_ref_index", one_without)


def invert_gate(monkeypatch):
    check = pp_generator.fb_consistency_check
    monkeypatch.setattr(pp_generator, "fb_consistency_check",
                        lambda *a, **k: 1 - check(*a, **k))


@pytest.mark.parametrize("fault", ["bf16", "drop_refs", "invert_gate"])
def test_check_fails_a_faulty_port(fault, port, weights, reference_call, monkeypatch,
                                   tmp_path):
    frames, mask, want, region = reference_call
    program = port
    if fault == "bf16":
        program = port_inpainter(weights[0], str(tmp_path), "bfloat16")
    elif fault == "drop_refs":
        drop_one_window_refs(monkeypatch)
    else:
        invert_gate(monkeypatch)
    widest, mean, _ = gaps(program([f.copy() for f in frames], mask), want, region)
    assert widest > MAX_U8 and mean > MEAN_U8, (widest, mean)


def test_reference_imports_no_jax_and_no_port():
    """In a fresh interpreter, and in the module's own import statements."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import perfbench.reference.propainter, perfbench.weights_propainter, "
            "perfbench.counts_propainter; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'flax', 'vsr_tpu', 'vsr_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert out.strip() == "[]", out
    tree = ast.parse((REPO / "perfbench" / "reference" / "propainter.py").read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m.split(".")[0] for m in imported} & {"jax", "vsr_tpu", "vsr_tpu_torch"}
