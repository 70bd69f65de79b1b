"""The token-attention CUDA kernel's wrapper and build (vsr_tpu_torch/ops/).

This file imports no jax, so the `cuda`-marked tests also run on a machine
with a card and no jax (the repo's conftest imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py -q

Here, without a card, they skip; the wrapper's checks and build logic run.
"""

import os
import time

import numpy as np
import pytest
import torch

from vsr_tpu_torch.ops import _build
from vsr_tpu_torch.ops import token_attention as ta

NEG_INF = -1e9
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _inputs(seed, shape, n_valid=None):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    bias = None
    if n_valid is not None:
        b = np.where(np.arange(shape[1])[None, :] < n_valid, 0.0, NEG_INF)
        bias = torch.from_numpy(np.broadcast_to(b, shape[:2]).astype(np.float32).copy())
    return q, k, v, bias


def test_wrapper_rejects_bad_inputs():
    """Shape, dtype and contiguity checks that run before any launch."""
    q, k, v, bias = _inputs(6, (1, 8, 16), n_valid=4)
    ta._check(q, k, v, bias)
    with pytest.raises(ValueError):
        ta._check(q, k[:, :4].contiguous(), v, bias)
    with pytest.raises(ValueError):
        ta._check(q.transpose(1, 2), k, v, bias)
    with pytest.raises(TypeError):
        ta._check(q.double(), k.double(), v.double(), bias)
    with pytest.raises(TypeError):
        ta._check(q, k, v, bias.double())
    with pytest.raises(ValueError):
        ta._check(q, k, v, bias[:, :3].contiguous())


def test_other_devices_raise():
    q = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no token-attention kernel"):
        ta.flash_token_attention(q, q, q)


def test_build_is_stale_when_a_source_is_newer(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    lib = tmp_path / "lib.so"
    src.write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "LIB_PATH", str(lib))
    assert _build._stale()  # no library yet
    lib.write_bytes(b"")
    now = time.time()
    os.utime(src, (now - 10, now - 10))
    assert not _build._stale()
    os.utime(src, (now + 10, now + 10))
    assert _build._stale()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No fallback: a build that fails raises and carries nvcc's output."""
    (tmp_path / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_valid", [
    ((2, 100, 300), None),   # N not a multiple of 64 rows, D not of 256 columns
    ((2, 100, 300), 70),     # key bias removes the last 30 keys
    ((1, 77, 960), 0),       # every key masked
    ((1, 64, 3200), 33),     # the (10,5) scale's width
])
def test_kernel_matches_reference(dtype, shape, n_valid, cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, k, v, bias = (None if t is None else t.to(cuda_device)
                     for t in _inputs(5, shape, n_valid))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = ta.launches
    got = ta.flash_token_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ta.token_attention_reference(q, k, v, bias)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_kernel_unaligned_bf16_inputs(cuda_device):
    """bf16 tiles are staged with 16-byte vector loads only when D % 8 == 0
    and the base pointers are 16-byte aligned; views that start 2 bytes in
    take the element-wise path and give the same result."""
    q, k, v, bias = (None if t is None else t.to(cuda_device)
                     for t in _inputs(7, (1, 96, 256), n_valid=50))
    flat = [torch.empty(1 + t.numel(), dtype=torch.bfloat16, device=cuda_device)
            for t in (q, k, v)]
    uq, uk, uv = (f[1:].view(t.shape) for f, t in zip(flat, (q, k, v)))
    for u, t in zip((uq, uk, uv), (q, k, v)):
        u.copy_(t)
    assert uq.data_ptr() % 16 != 0 and uq.is_contiguous()
    got = ta.flash_token_attention(uq, uk, uv, bias)
    want = ta.flash_token_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias)
    ref = ta.token_attention_reference(uq, uk, uv, bias)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               **BF16_TOL)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **BF16_TOL)


@pytest.mark.cuda
def test_kernel_masked_keys_do_not_leak(cuda_device):
    q, k, v, bias = (t.to(cuda_device) for t in _inputs(1, (2, 96, 128), n_valid=70))
    got = ta.flash_token_attention(q, k, v, bias)
    k2, v2 = k.clone(), v.clone()
    k2[:, 70:] = 100.0
    v2[:, 70:] = -50.0
    got2 = ta.flash_token_attention(q, k2, v2, bias)
    np.testing.assert_allclose(got2.cpu().numpy(), got.cpu().numpy(), **F32_TOL)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    q, k, v, _ = (t for t in _inputs(2, (1, 32, 16)))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    before = ta.launches
    with pytest.raises(ValueError, match="contiguous"):
        ta.flash_token_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    assert ta.launches == before
