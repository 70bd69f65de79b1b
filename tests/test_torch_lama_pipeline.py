"""The port's LaMa modes through its entry points against the JAX package's,
on the same inputs and the same .npz, with the tiny generator of
tests/test_lama.py in fp32 and a stub detector: SubtitleRemover.run() in
lama mode on a small mp4, picture mode writing no_sub/<name>.png, and the
CLI for both. vsr_tpu runs under VSR_LAMA_H2D=bgr, VSR_LAMA_BAND_D2H=bgr
and VSR_LAMA_BUCKET=8, the settings the port's outputs equal."""

import os

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_detect import _variables
from tests.test_torch_sttn_det import StubDetector, _read_back, _recording_writer
from vsr_tpu.config import Config as JaxConfig
from vsr_tpu.config import InpaintMode as JaxMode
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.models.lama import LamaGenerator as FlaxLama
from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.models.lama import LamaGenerator

TINY = dict(ngf=8, n_downsampling=2, n_blocks=1)
MAX_U8 = 1


class PictureDetector(StubDetector):
    def detect_subtitle(self, img):
        return [(20, 110, 50, 70)]  # xmin, xmax, ymin, ymax


@pytest.fixture(scope="module")
def lama_dir(tmp_path_factory):
    """A checkpoint directory holding the tiny generator's lama.npz."""
    d = tmp_path_factory.mktemp("models")
    variables = _variables(FlaxLama(**TINY), 21, jnp.zeros((1, 32, 32, 3)),
                           jnp.zeros((1, 32, 32, 1)))
    save_params(str(d / "lama.npz"), variables)
    return str(d)


@pytest.fixture
def tiny_lama(monkeypatch):
    """Both packages' LamaInpainter build the tiny generator; vsr_tpu in
    its exact-BGR, mod-8 settings."""
    from vsr_tpu.inpaint import lama as jmod
    from vsr_tpu_torch.inpaint import lama as tmod

    for var in ("VSR_LAMA_H2D", "VSR_LAMA_BAND_D2H"):
        monkeypatch.setenv(var, "bgr")
    monkeypatch.setenv("VSR_LAMA_BUCKET", "8")
    monkeypatch.setattr(jmod, "LamaGenerator", lambda **kw: FlaxLama(**{**kw, **TINY}))
    monkeypatch.setattr(tmod, "LamaGenerator", lambda **kw: LamaGenerator(**{**kw, **TINY}))


@pytest.fixture(scope="module")
def subtitle_video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "sub.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (160, 120))
    base = np.random.default_rng(0).integers(40, 200, (120, 160, 3), np.uint8)
    for i in range(30):
        frame = np.roll(base, i, axis=1).copy()
        cv2.putText(frame, "SUB", (50, 112), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1)
        w.write(frame)
    w.release()
    return path


def _configs(mode):
    return [cls(compute_dtype="float32", inpaint_mode=mode_cls(mode))
            for cls, mode_cls in ((JaxConfig, JaxMode), (Config, InpaintMode))]


def test_remover_run_lama_matches_jax(tiny_lama, lama_dir, subtitle_video, tmp_path,
                                      monkeypatch):
    """lama mode with the stub detector: each package builds its
    LamaInpainter lazily from lama.npz; the frames handed to the encoder
    agree within 1 uint8 (max 1, measured), frames outside the detected
    ranges pass through, the encoded file has 30 frames of 160x120."""
    import vsr_tpu.pipeline as jpipe
    import vsr_tpu_torch.pipeline as tpipe

    written = []
    for pipe, cfg in zip((jpipe, tpipe), _configs("lama")):
        rec = _recording_writer(pipe, monkeypatch)
        out = str(tmp_path / f"{pipe.__name__}.mp4")
        kw = {} if pipe is jpipe else {"device": "cpu"}
        remover = pipe.SubtitleRemover(subtitle_video, output_path=out, config=cfg,
                                       checkpoint_dir=lama_dir, **kw)
        remover._detector = StubDetector()
        remover.run()
        assert remover.is_finished
        written.append(np.stack(rec).astype(int))
        if pipe is tpipe:
            assert remover.lama_inpaint.device.type == "cpu"
            assert len(_read_back(out)) == 30
    want, got = written
    assert got.shape == want.shape == (30, 120, 160, 3)
    assert np.abs(got - want).max() <= MAX_U8
    src = np.stack(_read_back(subtitle_video)).astype(int)
    np.testing.assert_array_equal(got[[0, 23, 29]], src[[0, 23, 29]])
    assert np.abs(got[4:20] - src[4:20]).max() > 0


def test_picture_mode_matches_jax(tiny_lama, lama_dir, tmp_path):
    """A 91x133 PNG: detection (stubbed) -> mask -> LaMa -> the default
    output <dir>/no_sub/<name>.png at the input's size, within 1 uint8 of
    vsr_tpu's (equal, measured); the whole model output is written, as the
    reference does, so the hole and the rest both changed."""
    import vsr_tpu.pipeline as jpipe
    import vsr_tpu_torch.pipeline as tpipe

    img = np.random.default_rng(2).integers(0, 256, (91, 133, 3), dtype=np.uint8)
    outs = []
    for pipe, cfg in zip((jpipe, tpipe), _configs("lama")):
        d = tmp_path / pipe.__name__
        d.mkdir()
        path = str(d / "pic.png")
        cv2.imwrite(path, img)
        kw = {} if pipe is jpipe else {"device": "cpu"}
        remover = pipe.SubtitleRemover(path, config=cfg, checkpoint_dir=lama_dir, **kw)
        remover._detector = PictureDetector()
        remover.run()
        assert remover.is_finished and remover.progress_total == 100
        assert os.path.abspath(remover.video_out_path) == str(d / "no_sub" / "pic.png")
        outs.append(cv2.imread(remover.video_out_path).astype(int))
    want, got = outs
    assert got.shape == want.shape == img.shape
    assert np.abs(got - want).max() <= MAX_U8
    assert np.abs(got[50:70, 20:110] - img[50:70, 20:110]).mean() > 1


def test_picture_without_boxes_is_copied(tiny_lama, lama_dir, tmp_path):
    """No box found: the picture is written unchanged (ref main.py:353-371)."""
    from vsr_tpu_torch.pipeline import SubtitleRemover

    class NoBoxes:
        def detect_subtitle(self, img):
            return []

    img = np.random.default_rng(3).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    path = str(tmp_path / "plain.png")
    cv2.imwrite(path, img)
    remover = SubtitleRemover(path, output_path=str(tmp_path / "out.png"),
                              config=Config(compute_dtype="float32"), device="cpu")
    remover._detector = NoBoxes()
    remover.run()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "out.png")), img)
    assert remover._lama is None  # LaMa was never built


def test_cli_runs_lama_and_picture(tiny_lama, lama_dir, subtitle_video, tmp_path,
                                   monkeypatch):
    """`python -m vsr_tpu_torch -i x.mp4 --inpaint-mode lama` and `-i x.png`
    (main(), in process, --device cpu, the stub detector): the video keeps
    its frame count and size, the picture lands in no_sub/."""
    from vsr_tpu_torch import cli
    from vsr_tpu_torch.pipeline import SubtitleRemover

    monkeypatch.setattr(SubtitleRemover, "detector", property(lambda self: PictureDetector()))
    out = str(tmp_path / "out.mp4")
    assert cli.main(["-i", subtitle_video, "-o", out, "--inpaint-mode", "lama",
                     "--models", lama_dir, "--device", "cpu"]) == 0
    frames = _read_back(out)
    assert len(frames) == 30 and frames[0].shape == (120, 160, 3)
    pic = str(tmp_path / "pic.png")
    cv2.imwrite(pic, frames[0])
    assert cli.main(["-i", pic, "--models", lama_dir, "--device", "cpu"]) == 0
    back = cv2.imread(str(tmp_path / "no_sub" / "pic.png"))
    assert back is not None and back.shape == (120, 160, 3)


@pytest.mark.parametrize("argv", [["--inpaint-mode", "lama"], []], ids=["lama", "picture"])
def test_cli_lama_modes_default_to_cuda(argv, subtitle_video, tmp_path):
    """Without --device both ask for the card, and raise where there is
    none: nothing carries on on the CPU."""
    from vsr_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    src = subtitle_video
    if not argv:
        src = str(tmp_path / "pic.png")
        cv2.imwrite(src, np.zeros((32, 48, 3), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-i", src] + argv)
