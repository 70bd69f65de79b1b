"""Port's patch attention and upsample (vsr_tpu_torch/ops/) against the JAX
package's (vsr_tpu/ops/patch_attention.py, upsample.py) on the same numpy
inputs, through the kernel route (on the CPU: the kernel's plain version)
and the dense route. Tolerance 1e-5 (fp32 both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsr_tpu.ops import patch_attention as jpa
from vsr_tpu.ops.upsample import upsample_bilinear_2x_align_corners as jax_upsample
from vsr_tpu.ops.upsample import upsample_bilinear_align_corners as jax_upsample_to
from vsr_tpu_torch.ops import patch_attention as tpa
from vsr_tpu_torch.ops.upsample import (
    upsample_bilinear_2x_align_corners,
    upsample_bilinear_align_corners,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_tokens_round_trip_and_order():
    x = np.random.default_rng(0).standard_normal((2, 3, 6, 8, 5)).astype(np.float32)
    got, dims = tpa._grid_to_tokens(torch.from_numpy(x), 3, 4)
    want, jdims = jpa._grid_to_tokens(jnp.asarray(x), 3, 4)
    assert dims == jdims
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tpa._tokens_to_grid(got, *dims)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("with_valid", [True, False])
def test_single_scale_matches_jax(use_kernel, with_valid):
    q, k, v = _qkv(3, (2, 4, 6, 8, 8))
    valid = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool) if with_valid else None
    got = tpa.patch_attention_single_scale(
        *map(torch.from_numpy, (q, k, v)), (4, 3),
        key_valid=None if valid is None else torch.from_numpy(valid),
        use_kernel=use_kernel)
    want = jpa.patch_attention_single_scale(
        *map(jnp.asarray, (q, k, v)), (4, 3),
        key_valid=None if valid is None else jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_single_scale_patch_mask_matches_jax():
    """Det-variant hole gating: key patches over half masked leave the keys."""
    q, k, v = _qkv(4, (1, 3, 6, 8, 4))
    hole = np.zeros((1, 3, 6, 8), np.float32)
    hole[:, 1:, 3:, :] = 1.0
    got = tpa.patch_attention_single_scale(
        *map(torch.from_numpy, (q, k, v)), (2, 3),
        key_valid=torch.tensor([[True, True, False]]),
        patch_masked=torch.from_numpy(hole))
    want = jpa.patch_attention_single_scale(
        *map(jnp.asarray, (q, k, v)), (2, 3),
        key_valid=jnp.asarray([[True, True, False]]),
        patch_masked=jnp.asarray(hole))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_multi_scale_matches_jax(use_kernel):
    q, k, v = _qkv(5, (2, 5, 6, 8, 16))
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    patches = ((4, 3), (2, 2))
    got = tpa.multi_scale_patch_attention(
        *map(torch.from_numpy, (q, k, v)), patches,
        key_valid=torch.from_numpy(valid), use_kernel=use_kernel)
    want = jpa.multi_scale_patch_attention(
        *map(jnp.asarray, (q, k, v)), patches, key_valid=jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_route_reaches_the_wrapper(monkeypatch):
    """Scales with D <= KERNEL_D_MAX go through flash_token_attention, wider
    ones do not."""
    seen = []
    real = tpa.flash_token_attention

    def spy(q, k, v, bias=None):
        seen.append(q.shape[-1])
        return real(q, k, v, bias)

    monkeypatch.setattr(tpa, "flash_token_attention", spy)
    monkeypatch.setattr(tpa, "KERNEL_D_MAX", 4 * 3 * 8)
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, (1, 2, 6, 8, 16)))
    tpa.multi_scale_patch_attention(q, k, v, ((4, 3), (8, 6)))
    assert seen == [4 * 3 * 8]


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (3, 6, 1, 4)])
def test_upsample_matches_jax(shape):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)  # NHWC
    got = upsample_bilinear_2x_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = jax_upsample(jnp.asarray(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,out_hw", [((1, 5, 6, 2), (13, 17)), ((2, 7, 3, 4), (4, 9)),
                                          ((1, 1, 4, 3), (5, 8))])
def test_upsample_to_size_matches_jax(shape, out_hw):
    """Any output size (tests/test_ops.py::test_arbitrary_size's (13, 17)
    among them), and the 2x form bit for bit through it."""
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)  # NHWC
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = upsample_bilinear_align_corners(xt, *out_hw)
    assert got.shape == (shape[0], shape[3], *out_hw)
    want = jax_upsample_to(jnp.asarray(x), *out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    h, w = shape[1:3]
    torch.testing.assert_close(upsample_bilinear_2x_align_corners(xt),
                               upsample_bilinear_align_corners(xt, 2 * h, 2 * w), rtol=0, atol=0)
