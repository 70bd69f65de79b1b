"""AB sections in sttn-auto: SubtitleRemover.run() of the port against the
JAX package's with ``ab_sections`` set, on a small mp4, the same seeded
params (a .npz both load) and a shrunk STTN, in fp32. Frames outside the
sections pass through as decoded; frames inside agree within 2 uint8 (the
repo's frame parity bound)."""

import os

import cv2
import numpy as np

import jax

from vsr_tpu.config import Config as JaxConfig
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.models.sttn import STTNGenerator

TINY = dict(channel=16, stack_num=2, patchsizes_override=((4, 3), (2, 2)))
INPUT_SIZE = (64, 48)
N_FRAMES = 24
SUB_AREA = (100, 112, 40, 120)  # ymin, ymax, xmin, xmax
SECTIONS = [range(3, 9), range(15, 20)]  # 0-based frame numbers, as the GUI sets them
MAX_U8 = 2


def _config(cls):
    """tests/test_torch_sttn_auto.py's tiny STTN settings, fp32."""
    cfg = cls()
    cfg.compute_dtype = "float32"
    cfg.sttn_max_load_num = 10
    cfg.sttn_reference_length = 4
    cfg.sttn_neighbor_stride = 2
    cfg.window_batch = 2
    return cfg


def _write_video(path):
    base = np.random.default_rng(2).integers(40, 200, (120, 160, 3), np.uint8)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (160, 120))
    for i in range(N_FRAMES):
        w.write(np.roll(base, 3 * i, axis=1).copy())
    w.release()


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


def _run(pipe, inpaint_mod, cfg, video, ckpt, out, sections, monkeypatch, **kw):
    """remover.run() in sttn-auto mode; the frames it handed its encoder."""
    written = []

    class Recording(pipe.VideoWriter):
        def write(self, frame):
            written.append(frame.copy())
            super().write(frame)

    monkeypatch.setattr(pipe, "VideoWriter", Recording)
    remover = pipe.SubtitleRemover(video, output_path=out, sub_areas=[SUB_AREA], config=cfg,
                                   checkpoint_dir=os.path.dirname(ckpt), **kw)
    remover.ab_sections = sections
    remover._sttn_auto = inpaint_mod.STTNAutoInpainter(ckpt, cfg, input_size=INPUT_SIZE, **kw)
    remover.run()
    assert remover.is_finished
    return np.stack(written).astype(int)


def test_sttn_auto_ab_sections_match_jax(tmp_path, monkeypatch):
    import vsr_tpu.inpaint.sttn_auto as jmod
    import vsr_tpu.pipeline as jpipe
    import vsr_tpu_torch.inpaint.sttn_auto as tmod
    import vsr_tpu_torch.pipeline as tpipe

    flax_model = FlaxSTTN(variant="auto", **TINY)
    params = flax_model.init(jax.random.PRNGKey(7), np.zeros((1, 1, 48, 64, 3), np.float32))
    ckpt = str(tmp_path / "sttn_auto.npz")
    save_params(ckpt, params)
    monkeypatch.setattr(jmod, "STTNGenerator",
                        lambda *, variant, dtype, use_pallas: FlaxSTTN(
                            variant=variant, dtype=dtype, use_pallas=use_pallas, **TINY))
    monkeypatch.setattr(tmod, "STTNGenerator",
                        lambda *, variant, use_kernel: STTNGenerator(
                            variant=variant, use_kernel=use_kernel, **TINY))
    video = str(tmp_path / "in.mp4")
    _write_video(video)

    want = _run(jpipe, jmod, _config(JaxConfig), video, ckpt, str(tmp_path / "jax.mp4"),
                SECTIONS, monkeypatch)
    got = _run(tpipe, tmod, _config(Config), video, ckpt, str(tmp_path / "port.mp4"),
               SECTIONS, monkeypatch, device="cpu")
    every = _run(tpipe, tmod, _config(Config), video, ckpt, str(tmp_path / "all.mp4"),
                 None, monkeypatch, device="cpu")

    src = np.stack(_read_back(video)).astype(int)
    assert got.shape == want.shape == every.shape == src.shape == (N_FRAMES, 120, 160, 3)
    inside = np.array([any(i in s for s in SECTIONS) for i in range(N_FRAMES)])
    np.testing.assert_array_equal(got[~inside], src[~inside])
    np.testing.assert_array_equal(want[~inside], src[~inside])
    assert np.abs(got[inside] - want[inside]).max() <= MAX_U8
    assert np.abs(got[inside] - src[inside]).max() > 0  # the band was rewritten
    assert np.abs(every[~inside] - src[~inside]).max() > 0  # without sections: every frame
