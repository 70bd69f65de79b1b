"""Port's STTN generator (vsr_tpu_torch/models/sttn.py) against the flax one
(vsr_tpu/models/sttn.py) on the tiny geometry of tests/test_sttn_model.py,
with the flax params carried over by sttn_state_dict_from_flax. Tolerance
1e-3 (the repo's activation-parity bound), fp32 both sides."""

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
