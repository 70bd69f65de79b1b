"""The port's PropainterInpainter (vsr_tpu_torch/inpaint/propainter.py)
against the JAX package's, on the same frames and the same three .npz files
(RAFT at corr_levels 2 / radius 2 / 2 iterations, the flow-completion net,
the tiny generator of tests/test_propainter.py), in fp32 on the CPU. The
JAX side runs under VSR_PP_DYNAMIC_WINDOWS=1, the reference's ragged window
scheduling, which the port keeps:

* inpaint() on 12 frames with chunked flow completion and image
  propagation (halo paths), overlapping windows and global references;
* the band __call__ on a frame whose mask needs one full-width band;
* outpaint();
each within 1 uint8 of vsr_tpu's, with the count of differing values
stated; outside the dilated mask bit-identical to the input. Also the
port's window-skip against its dense attention (bit for bit), the
loaders, and the helpers' parity.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_detect import _variables
from vsr_tpu.config import Config as JaxConfig
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.inpaint import propainter as jax_pp
from vsr_tpu.models.propainter.flow_completion import RecurrentFlowCompleteNet as FlaxFlowNet
from vsr_tpu.models.propainter.generator import ProPainterGenerator as FlaxGenerator
from vsr_tpu.models.propainter.raft import RAFT as FlaxRAFT
from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint import propainter as pp
from vsr_tpu_torch.utils import tracing

TINY_GEN = dict(channel=16, hidden=32, depths=2, n_head=2, window_size=(3, 4), pool_size=(2, 2))
RAFT_KW = dict(corr_levels=2, corr_radius=2)
MAX_U8 = 1


def write_checkpoints(directory, seed=30):
    """raft.npz, flow_completion.npz and propainter.npz of the tiny
    configuration, drawn from numpy (biases and BatchNorm statistics too)."""
    img = jnp.zeros((1, 64, 64, 3))
    flax_gen = FlaxGenerator(**TINY_GEN)

    class _GenInit:
        init = staticmethod(lambda rng: flax_gen.init(
            rng, jnp.zeros((1, 3, 64, 64, 3)),
            (jnp.zeros((1, 1, 64, 64, 2)), jnp.zeros((1, 1, 64, 64, 2))),
            jnp.zeros((1, 3, 64, 64, 1)), jnp.zeros((1, 3, 64, 64, 1)), 2))

    save_params(str(directory / "raft.npz"), _variables(FlaxRAFT(**RAFT_KW), seed, img, img))
    save_params(str(directory / "flow_completion.npz"), _variables(
        FlaxFlowNet(), seed + 1, jnp.zeros((1, 2, 64, 64, 2)), jnp.zeros((1, 2, 64, 64, 1))))
    save_params(str(directory / "propainter.npz"), _variables(_GenInit, seed + 2))
    return str(directory)


def configs(**fields):
    """Both packages' Config in fp32 with 2 RAFT iterations."""
    out = []
    for cls in (JaxConfig, Config):
        cfg = cls(compute_dtype="float32", **fields)
        cfg.propainter_raft_iters = 2
        out.append(cfg)
    return out


def make_inpainters(ckpt_dir, **fields):
    jax_cfg, cfg = configs(**fields)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VSR_PP_DYNAMIC_WINDOWS", "1")
        jax_inp = jax_pp.PropainterInpainter(ckpt_dir, jax_cfg, dict(TINY_GEN), dict(RAFT_KW))
    assert not jax_inp.static_windows
    inp = pp.PropainterInpainter(ckpt_dir, cfg, dict(TINY_GEN), dict(RAFT_KW), device="cpu")
    return jax_inp, inp


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return write_checkpoints(tmp_path_factory.mktemp("pp_models"))


@pytest.fixture(scope="module")
def inpainters(ckpt_dir):
    """Windows of 3 + 1 + 3 frames (neighbor_length 6), references every 4
    frames, sub-videos of 8 frames: a 12-frame clip runs the chunked
    completion and propagation and ref_num = 2 references a window."""
    return make_inpainters(ckpt_dir, propainter_neighbor_length=6, propainter_ref_stride=4,
                           propainter_subvideo_length=8)


def _frames(seed, n, h, w):
    base = np.random.default_rng(seed).integers(0, 256, (h, w + 2 * n, 3), np.uint8)
    return [np.ascontiguousarray(base[:, 2 * i:2 * i + w]) for i in range(n)]


def _u8_close(want, got):
    """Within MAX_U8; returns how many values differ."""
    want, got = np.stack(want).astype(int), np.stack(got).astype(int)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= MAX_U8, (diff.max(), int((diff > 0).sum()))
    return int((diff > 0).sum())


def _outside_untouched(src, got, hole):
    src, got = np.stack(src), np.stack(got)
    np.testing.assert_array_equal(got[:, ~hole], src[:, ~hole])
    assert np.abs(got.astype(int) - src.astype(int))[:, hole].mean() > 1


def test_inpaint_matches_jax(inpainters):
    """12 frames of 48x64: within 1 uint8 of vsr_tpu (1 of 110,592 values
    differs, by 1, measured), outside the dilated mask bit-identical."""
    jax_inp, inp = inpainters
    frames = _frames(1, 12, 48, 64)
    mask = np.zeros((48, 64), np.uint8)
    mask[16:30, 12:44] = 255
    got = inp.inpaint([f.copy() for f in frames], mask)
    want = jax_inp.inpaint([f.copy() for f in frames], mask)
    assert len(got) == 12 and got[0].dtype == np.uint8
    print("differing values:", _u8_close(want, got))
    _outside_untouched(frames, got, pp.dilate_mask(mask, 4) > 0)


def test_band_call_matches_jax(inpainters):
    """6 frames of 96x128, the mask near the bottom: one band of
    128 * 3 / 16 = 24 rows, a multiple of 8; within 1 uint8 of vsr_tpu (1 of
    221,184 values differs, measured); outside the dilated mask untouched."""
    jax_inp, inp = inpainters
    frames = _frames(2, 6, 96, 128)
    mask = np.zeros((96, 128), np.uint8)
    mask[72:82, 20:100] = 255
    bands = pp.get_inpaint_area_by_mask(128, 96, 24, mask[:, :, None], multiple=8)
    assert len(bands) == 1 and (bands[0][1] - bands[0][0]) % 8 == 0
    got = inp([f.copy() for f in frames], mask)
    want = jax_inp([f.copy() for f in frames], mask)
    assert len(got) == 6
    print("differing values:", _u8_close(want, got))
    hole = np.zeros((96, 128), bool)
    ymin, ymax = bands[0][:2]
    hole[ymin:ymax] = pp.dilate_mask(mask[ymin:ymax], 4) > 0
    _outside_untouched(frames, got, hole)


def test_outpaint_matches_jax(inpainters):
    """4 frames of 64x96 scaled by 1.25: an 80x120 canvas, the source in
    its centre untouched, the border synthesised; within 1 uint8 of vsr_tpu
    (1 of 115,200 values differs, measured)."""
    jax_inp, inp = inpainters
    frames = _frames(3, 4, 64, 96)
    got = inp.outpaint([f.copy() for f in frames], (1.25, 1.25))
    want = jax_inp.outpaint([f.copy() for f in frames], (1.25, 1.25))
    assert got[0].shape == (80, 120, 3)
    print("differing values:", _u8_close(want, got))
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g[8:72, 12:108], f)


def test_window_skip_equals_dense(inpainters):
    """The masked branch run only for the hole's windows (a strict subset
    here) composites the same bytes as every window running both branches."""
    _, inp = inpainters
    frames = _frames(4, 5, 48, 128)
    mask = np.zeros((48, 128), np.uint8)
    mask[30:40, 40:64] = 255
    dilated = pp.dilate_mask(mask, inp.mask_dilation)
    plan = inp._plan((0, 48, 0, 128), dilated, dilated)
    mw = plan.masked_windows
    assert mw is not None and 0 < len(mw)
    clip = tracing.span("vsr.pp.clip")
    skip = inp._inpaint_bands(frames, [plan], clip)
    dense = inp._inpaint_bands(frames, [plan._replace(masked_windows=None)], clip)
    for a, b in zip(skip, dense):
        np.testing.assert_array_equal(a, b)


def test_empty_mask_is_identity(inpainters):
    _, inp = inpainters
    frames = _frames(5, 3, 32, 48)
    for out in (inp(frames, np.zeros((32, 48), np.uint8)),
                inp.inpaint(frames, np.zeros((32, 48), np.uint8))):
        for a, b in zip(out, frames):
            np.testing.assert_array_equal(a, b)
            assert a is not b


@pytest.mark.parametrize("seed", range(3))
def test_helpers_match_jax(inpainters, seed):
    """get_ref_index, dilate_mask, short_clip_len_for_width, the window
    lists and the masked-window set, on random inputs."""
    jax_inp, inp = inpainters
    rng = np.random.default_rng(40 + seed)
    for _ in range(20):
        length = int(rng.integers(1, 120))
        mid = int(rng.integers(0, length))
        ns = list(range(max(0, mid - 5), min(length, mid + 6)))
        stride, num = int(rng.integers(1, 12)), int(rng.choice([-1, 0, 1, 4, 8]))
        assert pp.get_ref_index(mid, ns, length, stride, num) == jax_pp.get_ref_index(
            mid, ns, length, stride, num)
    m = (rng.uniform(0, 1, (40, 56)) > 0.97).astype(np.uint8) * 255
    np.testing.assert_array_equal(pp.dilate_mask(m, 4), jax_pp.dilate_mask(m, 4))
    for w in (320, 640, 700, 1280, 1920):
        assert pp.short_clip_len_for_width(w) == jax_pp.short_clip_len_for_width(w)
    hole = np.zeros((96, 160), np.float32)
    y, x = int(rng.integers(0, 80)), int(rng.integers(0, 140))
    hole[y:y + 12, x:x + 20] = 1
    want = jax_inp._masked_window_set(hole)
    got = inp._masked_window_set(hole)
    assert (want is None) == (got is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_load_propainter_weights(ckpt_dir, tmp_path):
    """The .npz files load bit for bit into what vsr_tpu holds; a .pth goes
    to the reference converter, which fails to unpickle an empty one
    (tests/test_torch_convert.py loads real ones); no checkpoint: seeded
    init."""
    from vsr_tpu_torch.convert.from_flax import propainter_state_dict_from_flax
    from vsr_tpu_torch.inpaint.weights import load_propainter_weights, load_raft_weights
    from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
    from vsr_tpu_torch.models.propainter.raft import RAFT

    with np.load(f"{ckpt_dir}/propainter.npz") as data:
        want = propainter_state_dict_from_flax({k: data[k] for k in data.files})
    model = ProPainterGenerator(**TINY_GEN)
    load_propainter_weights(model, f"{ckpt_dir}/propainter.npz")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    pth = tmp_path / "raft-things.pth"
    pth.write_bytes(b"")
    with pytest.raises(EOFError):
        load_raft_weights(RAFT(**RAFT_KW), str(pth))
    a, b = ProPainterGenerator(**TINY_GEN), ProPainterGenerator(**TINY_GEN)
    for m in (a, b):
        load_propainter_weights(m, None, seed=4)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k


def test_raft_chunks_follow_free_memory():
    """Pairs a RAFT call takes: what half the free memory holds, at least
    one, at most all; all of them on the CPU."""
    from vsr_tpu_torch.utils.device import items_per_chunk

    assert pp.raft_pair_bytes(360, 1920) == pytest.approx(0.625e9, rel=0.01)
    assert items_per_chunk(torch.device("cpu"), 69, 1e12) == 69
