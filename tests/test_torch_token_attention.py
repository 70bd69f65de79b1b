"""Port's token attention (vsr_tpu_torch/ops/token_attention.py) against the
JAX package's Pallas kernel in interpret mode and its dense XLA path, on the
cases of tests/test_pallas_attention.py. On the CPU the port's wrapper runs
its plain version; the CUDA kernel itself is held against the plain version
on the card by tests/test_torch_kernel_cuda.py and chip_smoke.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vsr_tpu.ops.pallas_token_attention import flash_token_attention as jax_flash
from vsr_tpu_torch.ops import token_attention as ta

NEG_INF = -1e9
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _xla_dense(q, k, v, bias=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = jnp.einsum("bnd,bmd->bnm", q, k,
                        preferred_element_type=jnp.float32) * scale
    if bias is not None:
        scores = scores + bias[:, None, :]
    attn = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bnm,bmd->bnd", attn.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _inputs(seed, shape, n_valid=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(dtype) for _ in range(3))
    bias = None
    if n_valid is not None:
        bias = np.where(np.arange(shape[1])[None, :] < n_valid, 0.0, NEG_INF)
        bias = np.broadcast_to(bias, shape[:2]).astype(np.float32).copy()
    return q, k, v, bias


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape,n_valid,qb,kb", [
    ((2, 64, 128), None, 16, 32),   # blocks divide evenly
    ((1, 40, 256), None, 16, 8),    # ragged N (Pallas divisor snapping)
    ((1, 24, 96), None, 256, 512),  # blocks larger than N
    ((2, 32, 64), 20, 16, 16),      # key bias removes the last 12 keys
    ((2, 40, 64), 0, 16, 128),      # every key masked
])
def test_reference_matches_pallas_and_dense(shape, n_valid, qb, kb):
    q, k, v, bias = _inputs(len(shape) + shape[1], shape, n_valid)
    got = ta.flash_token_attention(*_torch(q, k, v, bias)).numpy()
    pallas = jax_flash(*_jax(q, k, v, bias), q_block=qb, k_block=kb, interpret=True)
    dense = _xla_dense(*_jax(q, k, v, bias))
    np.testing.assert_allclose(got, np.asarray(pallas), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(dense), **F32_TOL)


def test_masked_keys_do_not_leak():
    """Perturbing keys and values under the -1e9 bias changes nothing."""
    q, k, v, bias = _inputs(1, (2, 32, 64), n_valid=20)
    got = ta.flash_token_attention(*_torch(q, k, v, bias))
    k2, v2 = k.copy(), v.copy()
    k2[:, 20:] = 100.0
    v2[:, 20:] = -50.0
    got2 = ta.flash_token_attention(*_torch(q, k2, v2, bias))
    np.testing.assert_allclose(got2.numpy(), got.numpy(), **F32_TOL)


def test_bf16_matches_pallas():
    q, k, v, _ = _inputs(2, (1, 48, 128))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    got = ta.flash_token_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, q_block=16, k_block=16, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v, bias = _inputs(4, (1, 16, 32), n_valid=10)
    before = ta.launches
    got = ta.flash_token_attention(*_torch(q, k, v, bias))
    want = ta.token_attention_reference(*_torch(q, k, v, bias))
    assert ta.launches == before
    assert torch.equal(got, want)
