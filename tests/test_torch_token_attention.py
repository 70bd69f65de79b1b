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


# ---- the numerics of the card's fp32 route, emulated in numpy ----
# csrc/token_attention.cu runs fp32 inputs as 3xTF32 on the tensor cores:
# each operand is split as hi = tf32(x), lo = tf32(x - hi), and a product is
# lo hi + hi lo + hi hi with fp32 sums. The emulation below follows the
# kernel's steps (128-key score tiles, per-tile row max and sum, the merge,
# each tile's products from raw p scaled by the tile's factor after) so the
# tolerance the card kernel is held to, 2e-5 (1 + |ref|), is pinned here
# without a card. The tensor cores' truncating sums are not emulated: the
# kernel adds each 32-deep stage's sum in rounded fp32 (see the .cu header).

LOG2E = np.float32(1.4426950408889634)


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero, on the 13 low mantissa bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b with tf32 operands and fp32 sums: three passes (lo hi + hi lo,
    then + hi hi, the kernel's order) or one (hi hi)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _emulated_f32_route(q, k, v, bias, passes, tile=128):
    scale_log2 = np.float32(1.0 / math.sqrt(q.shape[-1])) * LOG2E
    out = []
    for qb, kb, vb, bb in zip(q, k, v, bias):
        s = _tf32_matmul(qb, kb.T, passes) * scale_log2 + bb * LOG2E
        tiles = [s[:, i:i + tile] for i in range(0, s.shape[1], tile)]
        m_t = [t.max(axis=1, keepdims=True) for t in tiles]
        p_t = [np.exp2(t - m) for t, m in zip(tiles, m_t)]
        m = np.max(np.concatenate(m_t, axis=1), axis=1, keepdims=True)
        l = sum(p.sum(axis=1, keepdims=True) * np.exp2(mt - m) for p, mt in zip(p_t, m_t))
        out.append(sum(_tf32_matmul(p, vb[i * tile:(i + 1) * tile], passes) * (np.exp2(mt - m) / l)
                       for i, (p, mt) in enumerate(zip(p_t, m_t))))
    return np.stack(out)


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("D", [960, 3200])
def test_tf32_split_meets_the_f32_tolerance(D, passes):
    """3xTF32 stays within 2e-5 (1 + |ref|) of token_attention_reference
    (measured ~1e-6 here, ~40x under); single-pass TF32 does not (~15x
    over), so the card kernel's fp32 check would catch a route that drops
    the lo products. Nk = 300 leaves the last 128-key tile ragged."""
    rng = np.random.default_rng(D)
    q = rng.standard_normal((1, 64, D)).astype(np.float32)
    k, v = (rng.standard_normal((1, 300, D)).astype(np.float32) for _ in range(2))
    bias = np.where(rng.random((1, 300)) < 0.3, NEG_INF, 0.0).astype(np.float32)
    ref = ta.token_attention_reference(*_torch(q, k, v, bias)).numpy()
    got = _emulated_f32_route(q, k, v, bias, passes)
    over = np.abs(got - ref) - 2e-5 * (1 + np.abs(ref))
    if passes == 3:
        assert over.max() <= 0
    else:
        assert over.max() > 0
