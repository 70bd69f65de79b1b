"""The port's ProPainter ops (vsr_tpu_torch/ops/grid_sample.py, unfold.py,
deform_conv.py, and RAFT's corr pyramid and window lookup) against the JAX
package's on the same numpy inputs, in fp32 on the CPU:

* grid_sample_bilinear / grid_sample_nearest / flow_warp within 1e-6, on
  fractional, out-of-range and exactly-on-edge coordinates (and .5 ties
  for nearest), C = 2, 3, 8 and 16 (the JAX package's C < 8 and blocked
  paths);
* unfold, fold and fold_normalizer within 1e-6;
* modulated_deform_conv within 1e-5 of both JAX paths (generic, and patch
  with a center and a residual bound);
* build_corr_pyramid within 1e-5 and lookup_corr at radius 1, 2 and 4
  within 1e-5 of the JAX package's default (one-hot) lookup.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsr_tpu.models.propainter import raft as jax_raft
from vsr_tpu.ops import deform_conv as jax_deform
from vsr_tpu.ops import grid_sample as jax_gs
from vsr_tpu.ops import unfold as jax_unfold
from vsr_tpu_torch.models.propainter import raft
from vsr_tpu_torch.ops import deform_conv, grid_sample, unfold


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _coords(rng, b, n, h, w):
    """n (x, y) pixel coordinates a batch: fractional ones spread past the
    image, the image's edges and one past them exactly, and .5 ties."""
    frac = np.stack([rng.uniform(-2.5, w + 1.5, (b, n)), rng.uniform(-2.5, h + 1.5, (b, n))], -1)
    xs = np.array([0, w - 1, -1, w, 0.5, w - 1.5, 2.5, -0.5, w - 0.5])
    ys = np.array([0, h - 1, -1, h, 1.5, h - 0.5, 0.5, -0.5, 3.5])
    edge = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    edge = np.broadcast_to(edge, (b, *edge.shape))
    return np.concatenate([frac, edge], 1).astype(np.float32)


@pytest.mark.parametrize("channels", [2, 3, 8, 16])
@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
def test_grid_sample_matches_jax(channels, kind):
    rng = np.random.default_rng(channels)
    b, h, w = 2, 7, 9
    img = rng.normal(0, 1, (b, h, w, channels)).astype(np.float32)
    coords = _coords(rng, b, 60, h, w).reshape(b, 3, -1, 2)
    jax_fn = jax_gs.grid_sample_bilinear if kind == "bilinear" else jax_gs.grid_sample_nearest
    fn = grid_sample.grid_sample_bilinear if kind == "bilinear" else grid_sample.grid_sample_nearest
    want = np.asarray(jax_fn(jnp.asarray(img), jnp.asarray(coords)))
    got = fn(_nchw(img), torch.from_numpy(coords)).numpy()
    assert got.shape == (b, channels, *coords.shape[1:-1])
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("channels", [2, 3, 16])
@pytest.mark.parametrize("interpolation", ["bilinear", "nearest"])
def test_flow_warp_matches_jax(channels, interpolation):
    rng = np.random.default_rng(10 + channels)
    b, h, w = 2, 12, 10
    x = rng.normal(0, 1, (b, h, w, channels)).astype(np.float32)
    flow = rng.normal(0, 3, (b, h, w, 2)).astype(np.float32)
    flow[:, ::3] = np.round(flow[:, ::3] * 2) / 2  # integer and .5 displacements
    want = np.asarray(jax_gs.flow_warp(jnp.asarray(x), jnp.asarray(flow), interpolation))
    got = grid_sample.flow_warp(_nchw(x), _nchw(flow), interpolation).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hw,kernel,stride,padding", [
    ((23, 31), (7, 7), (3, 3), (3, 3)),  # SoftSplit / SoftComp
    ((12, 10), (3, 2), (2, 1), (1, 0)),
])
def test_unfold_fold_match_jax(hw, kernel, stride, padding):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, *hw, 5)).astype(np.float32)
    want = np.asarray(jax_unfold.unfold(jnp.asarray(x), kernel, stride, padding))
    tokens = unfold.unfold(_nchw(x), kernel, stride, padding)
    np.testing.assert_allclose(tokens.numpy(), want, rtol=1e-6, atol=1e-6)
    oh, ow = want.shape[1:3]
    assert (oh, ow) == tuple(unfold.unfold_output_size(s, k, st, p)
                             for s, k, st, p in zip(hw, kernel, stride, padding))
    t = rng.normal(0, 1, want.shape).astype(np.float32)
    want_fold = np.asarray(jax_unfold.fold(jnp.asarray(t), hw, kernel, stride, padding))
    got_fold = unfold.fold(torch.from_numpy(t), hw, kernel, stride, padding).numpy()
    np.testing.assert_allclose(np.moveaxis(got_fold, 1, -1), want_fold, rtol=1e-6, atol=1e-6)
    want_norm = np.asarray(jax_unfold.fold_normalizer(hw, kernel, stride, padding, oh, ow))
    got_norm = unfold.fold_normalizer(hw, kernel, stride, padding, oh, ow).numpy()
    np.testing.assert_array_equal(np.moveaxis(got_norm, 1, -1), want_norm)


@pytest.mark.parametrize("path", ["generic", "patch"])
@pytest.mark.parametrize("groups,channels", [(4, 16), (16, 16), (2, 6)])
def test_modulated_deform_conv_matches_jax(path, groups, channels):
    """Offsets = a flow-like center + a tanh-bounded residual (bound 3), as
    ProPainter's alignment makes them; some taps land outside the image."""
    rng = np.random.default_rng(groups * 100 + channels)
    b, h, w, cout, bound = 2, 9, 11, 7, 3.0
    x = rng.normal(0, 1, (b, h, w, channels)).astype(np.float32)
    center = rng.normal(0, 2.5, (b, h, w, 2)).astype(np.float32)
    residual = bound * np.tanh(rng.normal(0, 1, (b, h, w, groups, 9, 2)))
    offset = (center[:, :, :, None, None, :] + residual).astype(np.float32)
    modulation = rng.uniform(0, 1, (b, h, w, groups, 9)).astype(np.float32)
    weight = (rng.normal(0, 1, (3, 3, channels, cout)) / np.sqrt(9 * channels)).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    kw = dict(center=jnp.asarray(center), residual_bound=bound) if path == "patch" else {}
    want = np.asarray(jax_deform.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(offset), jnp.asarray(modulation), jnp.asarray(weight),
        jnp.asarray(bias), **kw))
    got = deform_conv.modulated_deform_conv(
        _nchw(x), torch.from_numpy(offset).permute(0, 3, 4, 5, 1, 2),
        torch.from_numpy(modulation).permute(0, 3, 4, 1, 2),
        torch.from_numpy(weight).permute(3, 2, 0, 1), torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_corr_lookup_matches_jax(radius):
    """A 4-level pyramid of 16x20 feature maps; centroids spread past every
    level's edges."""
    rng = np.random.default_rng(radius)
    b, h, w, c = 2, 16, 20, 32
    f1 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    f2 = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    want_pyr = jax_raft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    pyr = raft.build_corr_pyramid(_nchw(f1), _nchw(f2), 4)
    for got, want in zip(pyr, want_pyr):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0], rtol=1e-5, atol=1e-5)
    coords = np.stack([rng.uniform(-6, w + 6, (b, h, w)), rng.uniform(-6, h + 6, (b, h, w))],
                      -1).astype(np.float32)
    coords[0, 0, :4] = [[0, 0], [w - 1, h - 1], [3, 2.5], [-1, 4]]
    want = np.asarray(jax_raft.lookup_corr(want_pyr, jnp.asarray(coords), radius))
    got = raft.lookup_corr(pyr, _nchw(coords), radius).numpy()
    assert got.shape == (b, 4 * (2 * radius + 1) ** 2, h, w)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-5, atol=1e-5)
