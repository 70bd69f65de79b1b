"""The port's propainter mode through its entry points against the JAX
package's: SubtitleRemover.run() on a small mp4 with a scene cut and a stub
detector, each remover building its PropainterInpainter and LamaInpainter
lazily from one checkpoint directory (the tiny ProPainter networks of
tests/test_torch_propainter.py, the tiny LaMa of tests/test_lama.py), fp32
on the CPU; vsr_tpu under VSR_PP_DYNAMIC_WINDOWS=1 and its exact-BGR, mod-8
LaMa settings. Also the CLI in propainter mode, and its cuda default."""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_detect import _variables
from tests.test_torch_propainter import RAFT_KW, TINY_GEN, write_checkpoints
from tests.test_torch_sttn_det import _read_back, _recording_writer
from vsr_tpu.config import Config as JaxConfig
from vsr_tpu.config import InpaintMode as JaxMode
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.models.lama import LamaGenerator as FlaxLama
from vsr_tpu.models.propainter.generator import ProPainterGenerator as FlaxGenerator
from vsr_tpu.models.propainter.raft import RAFT as FlaxRAFT
from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.models.lama import LamaGenerator
from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
from vsr_tpu_torch.models.propainter.raft import RAFT

LAMA_TINY = dict(ngf=8, n_downsampling=2, n_blocks=1)
MAX_U8 = 1
N_FRAMES, H, W = 28, 112, 192
CUT = 16  # the first frame of the second scene (1-based)
BOX = (30, 160, 80, 90)  # xmin, xmax, ymin, ymax


class SceneStubDetector:
    """The box on frames 5..22 (a run across the scene cut) and on frame 26
    alone (LaMa's)."""

    def find_subtitle_frame_no(self, sub_remover=None):
        return {f: [BOX] for f in [*range(5, 23), 26]}


@pytest.fixture(scope="module")
def models_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    write_checkpoints(d)
    lama = _variables(FlaxLama(**LAMA_TINY), 21, jnp.zeros((1, 32, 32, 3)),
                      jnp.zeros((1, 32, 32, 1)))
    save_params(str(d / "lama.npz"), lama)
    return str(d)


@pytest.fixture
def tiny_models(monkeypatch):
    """Both packages' inpainters build the tiny networks; vsr_tpu with the
    reference's ragged windows and its exact-BGR, mod-8 LaMa settings."""
    from vsr_tpu.inpaint import lama as jlama
    from vsr_tpu.inpaint import propainter as jpp
    from vsr_tpu_torch.inpaint import lama as tlama
    from vsr_tpu_torch.inpaint import propainter as tpp

    monkeypatch.setenv("VSR_PP_DYNAMIC_WINDOWS", "1")
    for var in ("VSR_LAMA_H2D", "VSR_LAMA_BAND_D2H"):
        monkeypatch.setenv(var, "bgr")
    monkeypatch.setenv("VSR_LAMA_BUCKET", "8")
    monkeypatch.setattr(jlama, "LamaGenerator", lambda **kw: FlaxLama(**{**kw, **LAMA_TINY}))
    monkeypatch.setattr(tlama, "LamaGenerator", lambda **kw: LamaGenerator(**{**kw, **LAMA_TINY}))
    monkeypatch.setattr(jpp, "ProPainterGenerator",
                        lambda **kw: FlaxGenerator(**{**kw, **TINY_GEN}))
    monkeypatch.setattr(tpp, "ProPainterGenerator",
                        lambda **kw: ProPainterGenerator(**{**kw, **TINY_GEN}))
    monkeypatch.setattr(jpp, "RAFT", lambda **kw: FlaxRAFT(**{**kw, **RAFT_KW}))
    monkeypatch.setattr(tpp, "RAFT", lambda **kw: RAFT(**{**kw, **RAFT_KW}))


@pytest.fixture(scope="module")
def scene_video(tmp_path_factory):
    """28 frames of 192x112 (cv2, mp4v): two unrelated drifting colour
    gradients with the cut at frame 16, subtitle text on frames 5..22 and
    26."""
    path = str(tmp_path_factory.mktemp("vid") / "scenes.mp4")
    yy, xx = np.mgrid[0:H, 0:W + N_FRAMES].astype(np.float32)
    bases = [np.stack([xx * 0.8 % 256, yy * 1.5 + 40, np.full_like(xx, 120)], -1),
             np.stack([np.full_like(xx, 30), 220 - yy, (xx + yy) * 0.6 % 256], -1)]
    bases = [b.clip(0, 255).astype(np.uint8) for b in bases]
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (W, H))
    for i in range(1, N_FRAMES + 1):
        frame = np.ascontiguousarray(bases[i >= CUT][:, i:i + W])
        if 5 <= i <= 22 or i == 26:
            cv2.putText(frame, "SUB", (60, 88), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        (255, 255, 255), 1)
        w.write(frame)
    w.release()
    return path


def _configs():
    out = []
    for cls, mode in ((JaxConfig, JaxMode), (Config, InpaintMode)):
        cfg = cls(compute_dtype="float32", inpaint_mode=mode("propainter"))
        cfg.propainter_raft_iters = 2
        out.append(cfg)
    return out


def test_scene_cut_splits_the_range(scene_video):
    from vsr_tpu_torch.masks.intervals import (
        find_continuous_ranges_with_same_mask, split_range_by_scene)
    from vsr_tpu_torch.scenes.content import get_scene_div_frame_no

    cuts = get_scene_div_frame_no(scene_video)
    assert cuts == [CUT]
    ranges = split_range_by_scene(
        find_continuous_ranges_with_same_mask(SceneStubDetector().find_subtitle_frame_no()), cuts)
    assert ranges == [(5, CUT - 1), (CUT, 22), (26, 26)]


def test_remover_run_propainter_matches_jax(tiny_models, models_dir, scene_video, tmp_path,
                                            monkeypatch):
    """propainter mode with the stub detector: frames 5..15 and 16..22 go
    to ProPainter as two clips, frame 26 to LaMa; the frames handed to the
    encoder agree with vsr_tpu's within 1 uint8, the rest pass through,
    the file has 28 frames of 192x112."""
    import vsr_tpu.pipeline as jpipe
    import vsr_tpu_torch.pipeline as tpipe

    written = []
    for pipe, cfg in zip((jpipe, tpipe), _configs()):
        rec = _recording_writer(pipe, monkeypatch)
        out = str(tmp_path / f"{pipe.__name__}.mp4")
        kw = {} if pipe is jpipe else {"device": "cpu"}
        remover = pipe.SubtitleRemover(scene_video, output_path=out, config=cfg,
                                       checkpoint_dir=models_dir, **kw)
        remover._detector = SceneStubDetector()
        remover.run()
        assert remover.is_finished
        written.append(np.stack(rec).astype(int))
        if pipe is tpipe:
            assert remover.propainter_inpaint.device.type == "cpu"
            assert remover.propainter_inpaint.generator.channel == TINY_GEN["channel"]
            assert len(_read_back(out)) == N_FRAMES
    want, got = written
    assert got.shape == want.shape == (N_FRAMES, H, W, 3)
    diff = np.abs(got - want)
    assert diff.max() <= MAX_U8, (diff.max(), int((diff > 0).sum()))
    src = np.stack(_read_back(scene_video)).astype(int)
    untouched = [i - 1 for i in range(1, N_FRAMES + 1) if not (5 <= i <= 22 or i == 26)]
    np.testing.assert_array_equal(got[untouched], src[untouched])
    for i in (5, 15, 16, 22, 26):
        assert np.abs(got[i - 1] - src[i - 1]).max() > 0, i


def test_cli_runs_propainter(tiny_models, models_dir, scene_video, tmp_path, monkeypatch):
    """`python -m vsr_tpu_torch -i x.mp4 --inpaint-mode propainter` (main(),
    in process, --device cpu, the stub detector): it no longer exits, and
    the output keeps the frame count and size."""
    from vsr_tpu_torch import cli
    from vsr_tpu_torch.pipeline import SubtitleRemover

    monkeypatch.setattr(SubtitleRemover, "detector", property(lambda self: SceneStubDetector()))
    out = str(tmp_path / "out.mp4")
    cfg_path = str(tmp_path / "config.json")
    _configs()[1].save(cfg_path)
    assert cli.main(["-i", scene_video, "-o", out, "--inpaint-mode", "propainter",
                     "--config", cfg_path, "--models", models_dir, "--device", "cpu"]) == 0
    frames = _read_back(out)
    assert len(frames) == N_FRAMES and frames[0].shape == (H, W, 3)


def test_cli_propainter_defaults_to_cuda(scene_video):
    """Without --device the mode asks for the card and raises where there
    is none: nothing carries on on the CPU."""
    from vsr_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-i", scene_video, "--inpaint-mode", "propainter"])
