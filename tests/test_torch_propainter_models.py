"""The port's ProPainter networks (vsr_tpu_torch/models/propainter/) against
the JAX package's on the same numpy inputs and the same params, carried by
the from_flax converters, in fp32 on the CPU:

* RAFT at iters=3, corr_levels=2, corr_radius=2 on 64x96: the encoders
  within 1e-4, the flow within 1e-3 px, convex upsampling within 1e-5;
  raft_bi_flows on two 4-frame clips at 32x48 within 1e-3 px of
  vsr_tpu's, within 1e-5 of per-pair forward, and bit-identical for
  every pair_chunk;
* RecurrentFlowCompleteNet.forward_bidirect_flow and combine_flow within
  1e-4;
* the tiny generator of tests/test_propainter.py (channel 16, hidden 32,
  2 blocks, 2 heads, window (3, 4), pool (2, 2)) stage by stage within
  1e-4: encode, image propagation (also as ``img_propagation``), feature propagation (with and without
  frame_valid), one transformer block (dense, frame_valid, masked_windows),
  decode and the whole forward_encoded;
* the three converters load strictly from flax's init params, keep the
  scans' one copy of their params, and raise on an unknown key;
  init_random_ starts LayerNorm and the pooling kernel as flax does.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detect import _variables
from vsr_tpu.models.propainter import generator as jax_gen
from vsr_tpu.models.propainter.flow_completion import (
    RecurrentFlowCompleteNet as FlaxFlowNet)
from vsr_tpu.models.propainter.generator import ProPainterGenerator as FlaxGenerator
from vsr_tpu.models.propainter.raft import RAFT as FlaxRAFT
from vsr_tpu.models.propainter.raft import convex_upsample_flow as jax_upsample
from vsr_tpu.models.propainter.raft import raft_bi_flows as jax_raft_bi_flows
from vsr_tpu_torch.convert.from_flax import (
    flow_completion_state_dict_from_flax,
    propainter_state_dict_from_flax,
    raft_state_dict_from_flax,
)
from vsr_tpu_torch.inpaint.weights import init_random_
from vsr_tpu_torch.models.propainter import generator as gen
from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet
from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
from vsr_tpu_torch.models.propainter import RAFT, raft_bi_flows
from vsr_tpu_torch.models.propainter.raft import convex_upsample_flow

TOL = dict(rtol=1e-4, atol=1e-4)
RAFT_KW = dict(iters=3, corr_levels=2, corr_radius=2)
TINY_GEN = dict(channel=16, hidden=32, depths=2, n_head=2, window_size=(3, 4), pool_size=(2, 2))


def _t(a):
    """NHWC / [B, T, H, W, C] numpy -> the port's NCHW / [B, T, C, H, W]."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def _np(t):
    """The port's channel-third-from-last tensor -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _gen_init_args(t=3, h=64, w=64):
    return (jnp.zeros((1, t, h, w, 3)), (jnp.zeros((1, 1, h, w, 2)), jnp.zeros((1, 1, h, w, 2))),
            jnp.zeros((1, t, h, w, 1)), jnp.zeros((1, t, h, w, 1)), 2)


def _gen_variables(seed=5):
    flax_model = FlaxGenerator(**TINY_GEN)

    class _Init:  # flax's init with the static local-frame count closed over
        init = staticmethod(lambda rng: flax_model.init(rng, *_gen_init_args()))

    return flax_model, _variables(_Init, seed)


# ---- RAFT ----


@pytest.fixture(scope="module")
def raft_pair():
    flax_model = FlaxRAFT(**RAFT_KW)
    img = jnp.zeros((1, 64, 64, 3))
    variables = _variables(flax_model, 2, img, img)
    model = RAFT(**RAFT_KW)
    model.load_state_dict(raft_state_dict_from_flax(variables), strict=True)
    return flax_model, variables, model.eval()


def _pair(seed, b=2, h=64, w=96):
    """Two frames in [-1, 1], the second the first shifted by (3, 2) px
    plus noise."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (b, h + 8, w + 8, 3)).astype(np.float32)
    return a[:, 4:h + 4, 4:w + 4], (a[:, 2:h + 2, 1:w + 1]
                                    + rng.normal(0, 0.05, (b, h, w, 3))).astype(np.float32)


def test_raft_encoder_matches_flax(raft_pair):
    flax_model, variables, model = raft_pair
    img, _ = _pair(1)
    want = flax_model.apply(variables, jnp.asarray(img), method="encode")
    with torch.no_grad():
        got = model.encode(_t(img))
    for g, w in zip(got, want):
        assert g.shape[1:] == (w.shape[-1], 8, 12)
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_raft_flow_matches_flax(raft_pair):
    flax_model, variables, model = raft_pair
    img1, img2 = _pair(2)
    want = np.asarray(flax_model.apply(variables, jnp.asarray(img1), jnp.asarray(img2)))
    with torch.no_grad():
        got = model(_t(img1), _t(img2))
    assert got.shape == (2, 2, 64, 96)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-3)
    assert np.abs(want).max() > 0.1  # the flow is not trivially zero


def test_convex_upsample_matches_flax():
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 2, (2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(0, 1, (2, 5, 7, 576)).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = convex_upsample_flow(_t(flow), _t(mask))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def _clips(seed, b=2, t=4, h=32, w=48):
    """b clips of t frames in [-1, 1], each frame the one before shifted by
    (1, 2) px, plus noise; the clips differ, so a pair across them shows."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (b, h + 2 * t, w + t, 3))
    frames = np.stack([base[:, 2 * i:2 * i + h, i:i + w] for i in range(t)], 1)
    return (frames + rng.normal(0, 0.05, frames.shape)).astype(np.float32)


def test_raft_bi_flows_matches_flax(raft_pair):
    flax_model, variables, model = raft_pair
    frames = _clips(4)
    want = jax_raft_bi_flows(flax_model, variables, jnp.asarray(frames))
    with torch.no_grad():
        got = raft_bi_flows(model, _t(frames))
    for g, w in zip(got, want):
        assert g.shape == (2, 3, 2, 32, 48)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-3)
    assert np.abs(np.asarray(want[0])).max() > 0.1  # not trivially zero


@pytest.mark.parametrize("pair_chunk", [None, 1, 4])
def test_raft_bi_flows_matches_per_pair_forward(raft_pair, pair_chunk):
    """Encode-once flows against RAFT.forward on each pair of each clip
    (tests/test_propainter.py::test_encode_once_matches_call for the JAX
    package); a pair_chunk of 1 or 4 of the 6 pairs (4 spans both clips)
    gives the flows of one call bit for bit."""
    _, _, model = raft_pair
    frames = _t(_clips(5))
    with torch.no_grad():
        ff, fb = raft_bi_flows(model, frames, pair_chunk=pair_chunk)
        whole = raft_bi_flows(model, frames)
        for b in range(2):
            for t in range(3):
                np.testing.assert_allclose(
                    ff[b, t].numpy(), model(frames[b, t:t + 1], frames[b, t + 1:t + 2])[0].numpy(),
                    rtol=1e-5, atol=1e-5)
                np.testing.assert_allclose(
                    fb[b, t].numpy(), model(frames[b, t + 1:t + 2], frames[b, t:t + 1])[0].numpy(),
                    rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ff, whole[0], rtol=0, atol=0)
    torch.testing.assert_close(fb, whole[1], rtol=0, atol=0)


# ---- flow completion ----


@pytest.fixture(scope="module")
def flow_pair():
    flax_model = FlaxFlowNet()
    variables = _variables(flax_model, 4, jnp.zeros((1, 2, 64, 64, 2)),
                           jnp.zeros((1, 2, 64, 64, 1)))
    model = RecurrentFlowCompleteNet()
    model.load_state_dict(flow_completion_state_dict_from_flax(variables), strict=True)
    return flax_model, variables, model.eval()


def _flows_and_masks(seed, t=5, h=32, w=48):
    rng = np.random.default_rng(seed)
    flows_f = rng.normal(0, 2, (1, t - 1, h, w, 2)).astype(np.float32)
    flows_b = rng.normal(0, 2, (1, t - 1, h, w, 2)).astype(np.float32)
    masks = np.zeros((1, t, h, w, 1), np.float32)
    for i in range(t):
        masks[0, i, 8 + i:20 + i, 10:36] = 1.0
    return flows_f, flows_b, masks


def test_flow_completion_matches_flax(flow_pair):
    flax_model, variables, model = flow_pair
    flows_f, flows_b, masks = _flows_and_masks(5)
    bi = (jnp.asarray(flows_f), jnp.asarray(flows_b))
    pred = flax_model.apply(variables, bi, jnp.asarray(masks),
                            method=flax_model.forward_bidirect_flow)
    want = FlaxFlowNet.combine_flow(bi, pred, jnp.asarray(masks))
    tbi = (_t(flows_f), _t(flows_b))
    with torch.no_grad():
        got_pred = model.forward_bidirect_flow(tbi, _t(masks))
    got = RecurrentFlowCompleteNet.combine_flow(tbi, got_pred, _t(masks))
    for g, w in zip(list(got_pred) + list(got), list(pred) + list(want)):
        assert g.shape == (1, 4, 2, 32, 48)
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


# ---- generator ----


@pytest.fixture(scope="module")
def gen_pair():
    flax_model, variables = _gen_variables()
    model = ProPainterGenerator(**TINY_GEN)
    model.load_state_dict(propainter_state_dict_from_flax(variables), strict=True)
    return flax_model, variables, model.eval()


def _window_inputs(seed, t=5, lt=3, h=48, w=96):
    """A window of lt local frames and t - lt refs: frames in [-1, 1],
    flows between the local frames, the same hole in every frame (in two of
    the four attention windows of the 4x8 token grid)."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)
    flows = [rng.normal(0, 1.5, (1, lt - 1, h, w, 2)).astype(np.float32) for _ in range(2)]
    masks = np.zeros((1, t, h, w, 1), np.float32)
    masks[:, :, 4:20, 4:40] = 1.0
    updated = masks.copy()
    updated[:, 1::2, 8:12] = 0.0
    return frames * (1 - masks), flows, masks, updated


def test_generator_encode_matches_flax(gen_pair):
    flax_model, variables, model = gen_pair
    frames, _, masks, updated = _window_inputs(6)
    want = flax_model.apply(variables, *map(jnp.asarray, (frames, masks, updated)),
                            method="encode")
    with torch.no_grad():
        got = model.encode(_t(frames), _t(masks), _t(updated))
    assert got.shape == (1, 5, 16, 12, 24)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_image_propagation_matches_flax():
    frames, flows, masks, _ = _window_inputs(7, t=5, lt=5)
    flows = [np.round(f * 2) / 2 for f in flows]  # .5 ties for the nearest warp
    want = jax_gen.image_propagation(jnp.asarray(frames), jnp.asarray(masks),
                                     *map(jnp.asarray, flows))
    got = gen.image_propagation(_t(frames), _t(masks), *map(_t, flows))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_img_propagation_is_image_propagation(gen_pair):
    """The reference model's method name, with its argument order (flows
    before masks), as vsr_tpu's ProPainterGenerator.img_propagation."""
    flax_model, variables, model = gen_pair
    frames, flows, masks, _ = _window_inputs(8, t=5, lt=5)
    flows = [np.round(f * 2) / 2 for f in flows]
    want = flax_model.apply(variables, jnp.asarray(frames), *map(jnp.asarray, flows),
                            jnp.asarray(masks), method="img_propagation")
    got = model.img_propagation(_t(frames), *map(_t, flows), _t(masks))
    same = gen.image_propagation(_t(frames), _t(masks), *map(_t, flows))
    for g, s, w in zip(got, same, want):
        torch.testing.assert_close(g, s, rtol=0, atol=0)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frame_valid", [None, [True, True, False, True]],
                         ids=["all-valid", "padded-slot"])
def test_feature_propagation_matches_flax(gen_pair, frame_valid):
    flax_model, variables, model = gen_pair
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 4, 12, 16, 16)).astype(np.float32)
    flows = [rng.normal(0, 1, (2, 3, 12, 16, 2)).astype(np.float32) for _ in range(2)]
    masks = (rng.uniform(0, 1, (2, 4, 12, 16, 2)) > 0.6).astype(np.float32)
    fv = None if frame_valid is None else np.array([frame_valid, [True] * 4])

    def run(m, *a):
        return m.feat_prop_module(*a, frame_valid=None if fv is None else jnp.asarray(fv))

    want = flax_model.apply(variables, *map(jnp.asarray, (x, *flows, masks)), method=run)
    with torch.no_grad():
        got = model.feat_prop_module(_t(x), *map(_t, flows), _t(masks),
                                     frame_valid=None if fv is None else torch.from_numpy(fv))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["dense", "frame_valid", "masked_windows"])
def test_transformer_block_matches_flax(gen_pair, case):
    """Block 1 (odd dilation subset) on a 10x14 token grid: windows (3, 4)
    pad it to 12x16; the hole covers some windows."""
    flax_model, variables, model = gen_pair
    rng = np.random.default_rng(9)
    T, lt, fh, fw = 5, 3, 10, 14
    tokens = rng.normal(0, 1, (1, T, fh, fw, 32)).astype(np.float32)
    mask = np.zeros((1, lt, fh, fw, 1), np.float32)
    mask[:, :, 4:8, 2:9] = 1.0
    t_ind = np.arange(1, T, 2)
    fv = np.array([[True, True, True, False, True]]) if case == "frame_valid" else None
    mw = np.array([4, 5, 6, 9, 10], np.int32) if case == "masked_windows" else None

    def run(m, tok, msk):
        return m.transformers[1](tok, (28, 40), msk, t_ind,
                                 None if fv is None else jnp.asarray(fv),
                                 None if mw is None else jnp.asarray(mw))

    want = np.asarray(flax_model.apply(variables, jnp.asarray(tokens), jnp.asarray(mask),
                                       method=run))
    with torch.no_grad():
        got = model.block1(torch.from_numpy(tokens), (28, 40), torch.from_numpy(mask[..., 0]),
                           t_ind, None if fv is None else torch.from_numpy(fv),
                           None if mw is None else torch.from_numpy(mw).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_matches_flax(gen_pair):
    flax_model, variables, model = gen_pair
    feat = np.random.default_rng(10).normal(0, 1, (2, 12, 16, 16)).astype(np.float32)
    want = flax_model.apply(variables, jnp.asarray(feat), method="decode")
    with torch.no_grad():
        got = model.decode(_t(feat))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["dense", "frame_valid", "masked_windows"])
def test_forward_encoded_matches_flax(gen_pair, case):
    """The whole post-encoder forward of one window (3 local frames, 2
    refs); with frame_valid the last ref is a padded slot; with
    masked_windows the hole's window set as the inpainter computes it,
    which must also equal the dense result."""
    from vsr_tpu.inpaint.propainter import PropainterInpainter as JaxInpainter

    flax_model, variables, model = gen_pair
    frames, flows, masks, updated = _window_inputs(11)
    enc = flax_model.apply(variables, *map(jnp.asarray, (frames, masks, updated)),
                           method="encode")
    fv = np.array([[True, True, True, True, False]]) if case == "frame_valid" else None
    mw = None
    if case == "masked_windows":
        holder = type("G", (), {"generator": flax_model})()
        mw = JaxInpainter._masked_window_set(holder, masks[0, 0, :, :, 0])
        assert mw is not None and 0 < len(mw) < 4
    want = np.asarray(flax_model.apply(
        variables, enc, tuple(map(jnp.asarray, flows)), jnp.asarray(masks),
        jnp.asarray(updated), 3, frame_valid=None if fv is None else jnp.asarray(fv),
        masked_windows=None if mw is None else jnp.asarray(mw), method="forward_encoded"))
    with torch.no_grad():
        t_enc = _t(np.asarray(enc))
        args = (t_enc, tuple(map(_t, flows)), _t(masks), _t(updated), 3)
        got = model.forward_encoded(
            *args, frame_valid=None if fv is None else torch.from_numpy(fv),
            masked_windows=None if mw is None else torch.from_numpy(mw).long())
        if case == "masked_windows":
            torch.testing.assert_close(got, model.forward_encoded(*args), rtol=0, atol=0)
        if case == "dense":  # the whole forward, encoder included
            whole = model(_t(frames), tuple(map(_t, flows)), _t(masks), _t(updated), 3)
            np.testing.assert_allclose(_np(whole), want, **TOL)
    assert got.shape == (1, 3, 3, 48, 96)
    np.testing.assert_allclose(_np(got), want, **TOL)


# ---- converters and init ----


def _flax_init(name):
    """flax's own init params of one network (jitted: eager init is slow)."""
    img = jnp.zeros((1, 64, 64, 3))
    if name == "raft":
        return jax.jit(FlaxRAFT(**RAFT_KW).init)(jax.random.PRNGKey(0), img, img)
    if name == "flow_completion":
        return jax.jit(lambda r: FlaxFlowNet().init(
            r, jnp.zeros((1, 2, 64, 64, 2)), jnp.zeros((1, 2, 64, 64, 1)), train=True)
        )(jax.random.PRNGKey(1))
    flax_gen = FlaxGenerator(**TINY_GEN)
    return jax.jit(lambda r: flax_gen.init(r, *_gen_init_args()))(jax.random.PRNGKey(2))


@pytest.mark.parametrize("name,convert,make,scan_key", [
    ("raft", raft_state_dict_from_flax, lambda: RAFT(**RAFT_KW),
     "step.update.gru.convz1.weight"),
    ("flow_completion", flow_completion_state_dict_from_flax,
     lambda: RecurrentFlowCompleteNet(edge_head=True), "prop.forward_sweep.align.weight"),
    ("propainter", propainter_state_dict_from_flax, lambda: ProPainterGenerator(**TINY_GEN),
     "feat_prop_module.backward_sweep.align.off3.weight"),
], ids=["raft", "flow_completion", "propainter"])
def test_converter_loads_strictly_from_flax_init(name, convert, make, scan_key):
    """flax's own init params (not the numpy draws above; the flow net's
    with its training-only edge head) load strictly; every converted leaf
    has the port module's shape, so a scan's params (RAFT's step/update,
    the propagation sweeps) carry no time axis."""
    model = make()
    state = convert(_flax_init(name))
    own = model.state_dict()
    assert set(state) == set(own)
    for k, v in state.items():
        assert v.shape == own[k].shape, k
    assert state[scan_key].ndim == own[scan_key].ndim
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("convert,bad", [
    (raft_state_dict_from_flax, {"params/fnet/layer9/conv1/kernel": np.zeros((3, 3, 2, 2))}),
    (raft_state_dict_from_flax, {"params/step/update/gru/convz1/scale_x": np.zeros(2)}),
    (flow_completion_state_dict_from_flax, {"params/prop/sideways/bb1/conv/kernel": np.zeros(2)}),
    (flow_completion_state_dict_from_flax, {"cache/down/kernel": np.zeros((1, 1, 1, 1, 1))}),
    (propainter_state_dict_from_flax, {"params/block0/attention/pool_kernel_x": np.zeros(2)}),
    (propainter_state_dict_from_flax, {"params/block0/attention/key/kernel": np.zeros(3)}),
    (propainter_state_dict_from_flax, {"params/transformer/kernel": np.zeros((2, 2))}),
])
def test_converters_reject_unknown_keys(convert, bad):
    with pytest.raises(KeyError):
        convert(bad)


def test_init_random_starts_norms_and_pool_as_flax():
    model = ProPainterGenerator(**TINY_GEN)
    init_random_(model, seed=1)
    attn = model.block0.attention
    assert torch.equal(model.block0.norm1.weight, torch.ones(32))
    assert torch.equal(model.block1.norm2.bias, torch.zeros(32))
    assert torch.equal(attn.pool_kernel, torch.full_like(attn.pool_kernel, 0.25))
    assert torch.equal(attn.pool_bias, torch.zeros(32))
    assert model.block0.attention.query.weight.std() > 0
    assert torch.equal(model.feat_prop_module.forward_sweep.align.bias, torch.zeros(16))
