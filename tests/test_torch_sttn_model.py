"""Port's STTN generator (vsr_tpu_torch/models/sttn.py) against the flax one
(vsr_tpu/models/sttn.py) on the tiny geometry of tests/test_sttn_model.py,
with the flax params carried over by sttn_state_dict_from_flax. Tolerance
1e-3 (the repo's activation-parity bound), fp32 both sides."""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from vsr_tpu.convert.torch_sttn import convert_sttn_state_dict
from vsr_tpu.models.sttn import STTNGenerator as FlaxSTTN
from vsr_tpu_torch.convert.from_flax import sttn_state_dict_from_flax
from vsr_tpu_torch.models.sttn import STTNGenerator

TINY_PATCHES = ((4, 3), (2, 2))
TINY_H, TINY_W = 24, 32  # /4 -> 6x8
C = 16
TOL = dict(rtol=1e-3, atol=1e-3)


def _pair(variant="auto", **kw):
    flax_model = FlaxSTTN(variant=variant, channel=C, stack_num=2,
                          patchsizes_override=TINY_PATCHES, **kw)
    x = jnp.zeros((1, 3, TINY_H, TINY_W, 3))
    args = (x, jnp.zeros((1, 3, TINY_H, TINY_W, 1))) if variant == "det" else (x,)
    params = flax_model.init(jax.random.PRNGKey(0), *args)
    model = STTNGenerator(variant=variant, channel=C, stack_num=2,
                          patchsizes_override=TINY_PATCHES, **kw)
    model.load_state_dict(sttn_state_dict_from_flax(params), strict=True)
    return flax_model, params, model.eval()


@pytest.fixture(scope="module")
def auto_pair():
    return _pair()


def test_encode_matches_flax(auto_pair):
    flax_model, params, model = auto_pair
    x = np.random.default_rng(0).uniform(-1, 1, (5, TINY_H, TINY_W, 3)).astype(np.float32)
    want = flax_model.apply(params, jnp.asarray(x), method=flax_model.encode)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x))
    assert got.shape == (5, TINY_H // 4, TINY_W // 4, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_transform_with_padded_windows_matches_flax(auto_pair, use_kernel):
    flax_model, params, model = auto_pair
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 7, TINY_H // 4, TINY_W // 4, C)).astype(np.float32)
    feats[0, 5:] = 999.0  # padded slots carry garbage; the key mask hides them
    valid = np.arange(7)[None] < np.array([[5], [7]])
    want = flax_model.apply(params, jnp.asarray(feats), jnp.asarray(valid), None,
                            method=flax_model.transform)
    for block in model.transformer:
        block.attention.use_kernel = use_kernel
    try:
        with torch.no_grad():
            got = model.transform(torch.from_numpy(feats), torch.from_numpy(valid))
    finally:
        for block in model.transformer:
            block.attention.use_kernel = True
    np.testing.assert_allclose(got.numpy()[0, :5], np.asarray(want)[0, :5], **TOL)
    np.testing.assert_allclose(got.numpy()[1], np.asarray(want)[1], **TOL)


def test_decode_matches_flax(auto_pair):
    flax_model, params, model = auto_pair
    f = np.random.default_rng(2).standard_normal(
        (4, TINY_H // 4, TINY_W // 4, C)).astype(np.float32)
    want = flax_model.apply(params, jnp.asarray(f), method=flax_model.decode)
    with torch.no_grad():
        got = model.decode(torch.from_numpy(f))
    assert got.shape == (4, TINY_H, TINY_W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_det_transform_with_hole_mask_matches_flax():
    flax_model, params, model = _pair("det", apply_attention_mask=True)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((1, 3, TINY_H // 4, TINY_W // 4, C)).astype(np.float32)
    hole = np.zeros((1, 3, TINY_H // 4, TINY_W // 4), np.float32)
    hole[:, :, 3:] = 1.0
    want = flax_model.apply(params, jnp.asarray(feats), None, jnp.asarray(hole),
                            method=flax_model.transform)
    with torch.no_grad():
        got = model.transform(torch.from_numpy(feats), None, torch.from_numpy(hole))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_keyed_state_dict_loads_strict(auto_pair):
    """A state dict keyed like the reference checkpoint's netG (built by the
    JAX package's own torch->flax key map, inverted) loads with strict=True
    and round-trips the flax params exactly."""
    _, params, model = auto_pair
    state = model.state_dict()
    fresh = STTNGenerator(channel=C, stack_num=2, patchsizes_override=TINY_PATCHES)
    fresh.load_state_dict({k: v.clone() for k, v in state.items()}, strict=True)
    back = traverse_util.flatten_dict(
        convert_sttn_state_dict({k: v.numpy() for k, v in state.items()}), sep="/")
    want = traverse_util.flatten_dict(params, sep="/")
    assert back.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(want[key]))


# The decoder's two upsample inputs, (40, 256, 30, 160) and (40, 64, 60, 320)
# at a TrainConfig() batch, cut in batch and channels: the spatial sizes set
# the interpolation weights and stay.
DECODER_SHAPES = [(2, 8, 30, 160), (2, 4, 60, 320)]


def _upsample_inputs(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:2] + (2 * shape[2], 2 * shape[3])).astype(np.float32)
    return x, g


def _torch_grad(fn, x, g):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    return y.detach(), torch.autograd.grad(y, xt, torch.tensor(g))[0]


def _interpolate(x):
    return torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear",
                                           align_corners=True)


@pytest.mark.parametrize("shape", DECODER_SHAPES, ids=["decoder-in", "decoder-mid"])
def test_upsample_forward_is_interpolate_and_backward_its_gradient(shape):
    """The forward is F.interpolate's bit for bit; the matmul backward equals
    F.interpolate's autograd gradient within 1e-6 relative (fp32 sums in
    another order)."""
    from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners

    x, g = _upsample_inputs(shape)
    y, grad = _torch_grad(upsample_bilinear_2x_align_corners, x, g)
    y_ref, grad_ref = _torch_grad(_interpolate, x, g)
    assert torch.equal(y, y_ref)
    rel = ((grad - grad_ref).abs().max() / grad_ref.abs().max()).item()
    assert rel <= 1e-6, rel


@pytest.mark.parametrize("shape", DECODER_SHAPES, ids=["decoder-in", "decoder-mid"])
def test_upsample_backward_matches_jax_grad(shape):
    """Against jax.grad of vsr_tpu's gather-and-lerp upsample (NHWC) on the
    same input. vsr_tpu forms the source coordinate in fp64, PyTorch (whose
    F.interpolate is the port's forward) in fp32, so the two ops already
    differ by that rounding in the forward (1.1e-4 at the 60x320 input). The
    backward is held to the activation-parity bound 1e-3 and to no more than
    F.interpolate's own autograd gradient's distance from jax.grad, plus
    fp32 sum rounding (1e-6 of the gradient's scale)."""
    from vsr_tpu.ops.upsample import upsample_bilinear_2x_align_corners as jax_upsample
    from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners

    x, g = _upsample_inputs(shape)
    _, vjp = jax.vjp(jax_upsample, jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))[0]).transpose(0, 3, 1, 2)
    got = _torch_grad(upsample_bilinear_2x_align_corners, x, g)[1].numpy()
    autograd = _torch_grad(_interpolate, x, g)[1].numpy()
    np.testing.assert_allclose(got, want, **TOL)
    err, autograd_err = np.abs(got - want).max(), np.abs(autograd - want).max()
    assert err <= autograd_err + 1e-6 * np.abs(want).max(), (err, autograd_err)


def test_upsample_interpolation_matrix_rows():
    """Each output row's weights sum to 1 and reproduce F.interpolate along
    one axis, including an axis of one pixel."""
    from vsr_tpu_torch.ops.upsample import interpolation_matrix

    for n_in, n_out in [(30, 60), (160, 320), (1, 4), (5, 1)]:
        a = interpolation_matrix(n_in, n_out)
        np.testing.assert_allclose(a.sum(axis=1), 1.0, atol=1e-6)
        x = torch.randn(1, 1, n_in, 3)
        want = torch.nn.functional.interpolate(x, size=(n_out, 3), mode="bilinear",
                                               align_corners=True)
        np.testing.assert_allclose(np.einsum("oi,ncij->ncoj", a, x.numpy()), want.numpy(),
                                   rtol=0, atol=1e-6)
