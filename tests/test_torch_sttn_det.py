"""The port's sttn-det slice against the JAX package's on the same frames
and params (a .npz both load): STTNDetInpainter.__call__ with the tiny model
of tests/test_sttn_det.py (channel 16, 2 blocks, input (64, 48)) in fp32,
SubtitleRemover.run() in sttn-det and opencv modes with a stub detector, and
the CLI. Frames are expected bit-identical in fp32; the stated limit is 2
uint8 (the repo's frame parity bound)."""

import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vsr_tpu.config import Config as JaxConfig
from vsr_tpu.config import InpaintMode as JaxMode
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.models.sttn import STTNGenerator

TINY = dict(channel=16, stack_num=2, patchsizes_override=((4, 3), (2, 2)))
INPUT_SIZE = (64, 48)
MAX_U8 = 2


def _config(cls, **kw):
    """tests/test_pipeline_modes.py's tiny STTN settings, fp32."""
    cfg = cls()
    cfg.compute_dtype = "float32"
    cfg.sttn_max_load_num = 10
    cfg.sttn_reference_length = 4
    cfg.sttn_neighbor_stride = 2
    cfg.window_batch = 2
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def det_ckpt(tmp_path_factory):
    flax_model = FlaxSTTN(variant="det", **TINY)
    h, w = INPUT_SIZE[1], INPUT_SIZE[0]
    params = flax_model.init(jax.random.PRNGKey(5), jnp.zeros((1, 1, h, w, 3)),
                             jnp.zeros((1, 1, h, w, 1)))
    path = str(tmp_path_factory.mktemp("sttn_det") / "sttn_det.npz")
    save_params(path, params)
    return path


@pytest.fixture
def tiny_models(monkeypatch):
    """Both packages' STTNDetInpainter build the tiny generator."""
    from vsr_tpu.inpaint import sttn_det as jmod
    from vsr_tpu_torch.inpaint import sttn_det as tmod

    monkeypatch.setattr(jmod, "STTNGenerator", lambda **kw: FlaxSTTN(**kw, **TINY))
    monkeypatch.setattr(tmod, "STTNGenerator", lambda **kw: STTNGenerator(**kw, **TINY))
    return jmod, tmod


def _inpainters(tiny_models, ckpt, apply_attention_mask=True, **cfg):
    jmod, tmod = tiny_models
    return (jmod.STTNDetInpainter(ckpt, _config(JaxConfig, **cfg), input_size=INPUT_SIZE,
                                  apply_attention_mask=apply_attention_mask),
            tmod.STTNDetInpainter(ckpt, _config(Config, **cfg), input_size=INPUT_SIZE,
                                  apply_attention_mask=apply_attention_mask, device="cpu"))


def _frames(n, h=120, w=160, seed=0):
    base = np.random.default_rng(seed).integers(30, 220, (h, w, 3), np.uint8)
    return [np.roll(base, 3 * i, axis=1).copy() for i in range(n)]


def _compare(want, got, frames, mask):
    want, got = np.stack(want).astype(int), np.stack(got).astype(int)
    src = np.stack(frames).astype(int)
    assert got.shape == want.shape == src.shape
    assert np.abs(got - want).max() <= MAX_U8
    outside = np.broadcast_to((mask == 0)[None, :, :, None], src.shape)
    np.testing.assert_array_equal(got[outside], src[outside])
    return np.abs(got - src)[~outside]


@pytest.mark.parametrize("apply_attention_mask", [True, False])
@pytest.mark.parametrize("n", [23, 6])
def test_inpainter_matches_jax(tiny_models, det_ckpt, apply_attention_mask, n):
    """23 frames: chunks of 10, 10 and 3 (clip = max load 10), three in
    flight; 6 frames: one chunk of 6 (clip = max(6, ref length 4)). With the
    attention's hole gating and without (the reference's no-op)."""
    jax_inp, inp = _inpainters(tiny_models, det_ckpt, apply_attention_mask)
    frames = _frames(n)
    mask = np.zeros((120, 160), np.uint8)
    mask[90:110, 30:130] = 255
    want = jax_inp([f.copy() for f in frames], mask)
    got = inp([f.copy() for f in frames], mask)
    assert len(got) == n
    assert _compare(want, got, frames, mask).mean() > 1  # the hole was rewritten


def test_empty_mask_identity(tiny_models, det_ckpt):
    _, inp = _inpainters(tiny_models, det_ckpt)
    frames = [np.full((120, 160, 3), 99, np.uint8) for _ in range(3)]
    out = inp(frames, np.zeros((120, 160), np.uint8))
    assert len(out) == 3
    for a, b in zip(out, frames):
        np.testing.assert_array_equal(a, b)
        assert a is not b


def test_clamped_band_ultrawide(tiny_models, det_ckpt):
    """H = 96 < split_h = 400*5/18 = 111: the band is clamped to the image,
    and paste-back resizes to the actual band height (tests/test_sttn_det.py)."""
    jax_inp, inp = _inpainters(tiny_models, det_ckpt, sttn_max_load_num=4,
                               sttn_reference_length=2, sttn_neighbor_stride=1)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (96, 400, 3), dtype=np.uint8) for _ in range(3)]
    mask = np.zeros((96, 400), np.uint8)
    mask[40:60, 100:300] = 255
    want = jax_inp([f.copy() for f in frames], mask)
    got = inp([f.copy() for f in frames], mask)
    assert len(got) == 3 and got[0].shape == (96, 400, 3)
    _compare(want, got, frames, mask)


def test_masked_engine_contract():
    """The masked engine takes masks of the chunk's shape and nothing else;
    an unmasked engine takes none."""
    from vsr_tpu_torch.inpaint.engine import STTNWindowEngine

    model = STTNGenerator(variant="det", **TINY).eval()
    frames = np.zeros((4, 24, 32, 3), np.uint8)
    masked = STTNWindowEngine(model, torch.device("cpu"), 4, (24, 32), stride=2,
                              ref_length=4, masked=True)
    with pytest.raises(ValueError, match="hole masks"):
        masked.dispatch(frames)
    with pytest.raises(ValueError, match="masks"):
        masked.dispatch(frames, np.zeros((4, 24, 31), np.uint8))
    plain = STTNWindowEngine(model, torch.device("cpu"), 4, (24, 32), stride=2, ref_length=4)
    with pytest.raises(ValueError, match="hole masks"):
        plain.dispatch(frames, np.zeros((4, 24, 32), np.uint8))


# ---- SubtitleRemover.run() and the CLI ----

class StubDetector:
    """A subtitle box on frames 5..20 (tests/test_pipeline_modes.py)."""

    def __init__(self, box=(40, 120, 100, 116), frames=range(5, 21)):
        self.box, self.frames = box, frames

    def find_subtitle_frame_no(self, sub_remover=None):
        return {f: [self.box] for f in self.frames}


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


def _recording_writer(module, monkeypatch):
    """Swap the pipeline's VideoWriter for one that also keeps each frame
    as it is handed to the encoder."""
    written = []

    class Recording(module.VideoWriter):
        def write(self, frame):
            written.append(frame.copy())
            super().write(frame)

    monkeypatch.setattr(module, "VideoWriter", Recording)
    return written


def _read_back(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.mark.parametrize("mode", ["sttn-det", "opencv"])
def test_remover_run_matches_jax(mode, tiny_models, det_ckpt, subtitle_video, tmp_path,
                                 monkeypatch):
    """Detection-driven run with the stub detector: the frames each package
    hands its encoder agree within 2 uint8 (bit-identical expected), the
    encoded files have 30 frames of 160x120 and agree within 2 uint8 with
    each other, and frames outside the detected ranges pass through."""
    import vsr_tpu.pipeline as jpipe
    import vsr_tpu_torch.pipeline as tpipe

    jmod, tmod = tiny_models
    outs, written = [], []
    for pipe, mode_cls, cfg_cls in ((jpipe, JaxMode, JaxConfig), (tpipe, InpaintMode, Config)):
        rec = _recording_writer(pipe, monkeypatch)
        out = str(tmp_path / f"{pipe.__name__}.mp4")
        cfg = _config(cfg_cls, inpaint_mode=mode_cls(mode))
        kw = {} if pipe is jpipe else {"device": "cpu"}
        remover = pipe.SubtitleRemover(subtitle_video, output_path=out, config=cfg,
                                       checkpoint_dir=os.path.dirname(det_ckpt), **kw)
        remover._detector = StubDetector()
        if mode == "sttn-det":
            det_mod = jmod if pipe is jpipe else tmod
            remover._sttn_det = det_mod.STTNDetInpainter(det_ckpt, cfg, input_size=INPUT_SIZE, **kw)
        remover.run()
        assert remover.is_finished
        written.append(np.stack(rec).astype(int))
        outs.append(np.stack(_read_back(out)).astype(int))
    (want, got), (want_file, got_file) = written, outs
    assert got.shape == want.shape == (30, 120, 160, 3)
    assert np.abs(got - want).max() <= MAX_U8
    assert got_file.shape == want_file.shape == (30, 120, 160, 3)
    assert np.abs(got_file - want_file).max() <= MAX_U8
    src = np.stack(_read_back(subtitle_video)).astype(int)
    # ranges 5..20 grow by 3 frames each way (config defaults): 2..23
    np.testing.assert_array_equal(got[[0, 23, 29]], src[[0, 23, 29]])
    assert np.abs(got[4:20] - src[4:20]).max() > 0


def test_remover_no_subtitles_raises(subtitle_video, tmp_path):
    from vsr_tpu_torch.pipeline import SubtitleRemover

    class EmptyDetector:
        def find_subtitle_frame_no(self, sub_remover=None):
            return {}

    remover = SubtitleRemover(subtitle_video, output_path=str(tmp_path / "o.mp4"),
                              config=_config(Config, inpaint_mode=InpaintMode.OPENCV),
                              device="cpu")
    remover._detector = EmptyDetector()
    with pytest.raises(RuntimeError, match="no subtitles"):
        remover.run()


@pytest.mark.parametrize("mode", ["sttn-det", "opencv"])
def test_cli_runs_detection_modes(mode, tiny_models, subtitle_video, tmp_path, monkeypatch):
    """`python -m vsr_tpu_torch -i ... --inpaint-mode sttn-det|opencv
    --device cpu` (its main(), in process, with the stub detector and the
    tiny STTN): the output keeps the frame count and size."""
    from vsr_tpu_torch import cli
    from vsr_tpu_torch.pipeline import SubtitleRemover

    _, tmod = tiny_models
    monkeypatch.setattr(SubtitleRemover, "detector", property(lambda self: StubDetector()))
    monkeypatch.setattr(SubtitleRemover, "sttn_det_inpaint", property(
        lambda self: tmod.STTNDetInpainter(None, self.config, input_size=INPUT_SIZE,
                                           device=self.device)))
    cfg_path = str(tmp_path / "config.json")
    _config(Config).save(cfg_path)
    out = str(tmp_path / "out.mp4")
    assert cli.main(["-i", subtitle_video, "-o", out, "--inpaint-mode", mode,
                     "--config", cfg_path, "--device", "cpu"]) == 0
    frames = _read_back(out)
    assert len(frames) == 30 and frames[0].shape == (120, 160, 3)


@pytest.mark.parametrize("mode", ["sttn-det", "opencv"])
def test_cli_detection_modes_default_to_cuda(mode, subtitle_video):
    """Without --device the detection modes ask for the card, and raise
    where there is none: nothing carries on on the CPU."""
    from vsr_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-i", subtitle_video, "--inpaint-mode", mode])
