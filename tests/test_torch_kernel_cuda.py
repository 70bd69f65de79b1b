"""The token-attention CUDA kernel's wrapper and build (vsr_tpu_torch/ops/).

This file imports no jax, so the `cuda`-marked tests also run on a machine
with a card and no jax (the repo's conftest imports jax, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py -q

Here, without a card, they skip; the wrapper's checks and build logic run.
"""

import copy
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
# bf16 also ||got - want|| / ||want|| <= BF16_REL: the element-wise bound is
# about as large as a typical output, so it misses a fault in the merge of
# one key tile's partial sums (chip_smoke.py, PERF.md).
BF16_REL = 1e-2


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
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **F32_TOL)
    else:
        _assert_bf16_close(got, want)


@pytest.mark.cuda
def test_kernel_unaligned_bf16_inputs(cuda_device):
    """The tensor maps need 16-byte aligned bases: views that start 2 bytes
    in go through the wrapper's aligned copy and give the same result."""
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
    _assert_bf16_close(got, want)
    _assert_bf16_close(got, ref)


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


def _bf16_case(seed, B, Nq, Nk, D, device, masked=0.3, dtype=torch.bfloat16):
    """q [B, Nq, D], k/v [B, Nk, D] in dtype (bf16 unless given) and an fp32
    bias masking about `masked` of the keys, made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, Nq, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, Nk, D)).astype(np.float32))
            for _ in range(2))
    bias = torch.from_numpy(np.where(rng.random((B, Nk)) < masked, NEG_INF, 0.0)
                            .astype(np.float32))
    return [t.to(device, dtype) for t in (q, k, v)] + [bias.to(device)]


def _assert_bf16_close(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.linalg.norm(got - want) <= BF16_REL * np.linalg.norm(want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 5120, 960), (1, 1536, 3200)], ids=["(5,3)", "(10,5)"])
def test_kernel_main_path_shapes_bf16(shape, cuda_device):
    """The two sttn-auto kernel scales at full size, as the main path calls them."""
    B, N, D = shape
    q, k, v, bias = _bf16_case(11, B, N, N, D, cuda_device)
    _assert_bf16_close(ta.flash_token_attention(q, k, v, bias),
                       ta.token_attention_reference(q, k, v, bias))


MAIN_PATH_SHAPES = {"(5,3)": (1, 5120, 960), "(10,5)": (1, 1536, 3200),
                    "(9,5) N=2304": (1, 2304, 2880), "(9,5) N=1728": (1, 1728, 2880)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MAIN_PATH_SHAPES.values()), ids=list(MAIN_PATH_SHAPES))
def test_kernel_main_path_shapes_f32(shape, cuda_device):
    """fp32 twin of the test above: the sttn-auto and sttn-det kernel scales
    at full size through the 3xTF32 route, within F32_TOL of the plain
    version in fp32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, N, D = shape
    q, k, v, bias = _bf16_case(17, B, N, N, D, cuda_device, dtype=torch.float32)
    before = ta.launches
    got = ta.flash_token_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ta.launches == before + 1 and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(),
                               ta.token_attention_reference(q, k, v, bias).cpu().numpy(),
                               **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,Nk,D", [(200, 300, 300), (130, 129, 77), (5, 1000, 3200)])
def test_kernel_f32_ragged(Nq, Nk, D, cuda_device):
    """fp32 with B = 2, Nk not a multiple of the 128-key tile, and D not a
    multiple of the 32-deep stage or the 160-column tile (77 also goes
    through the aligned copy); one query tile's worth of rows or fewer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, bias = _bf16_case(18, 2, Nq, Nk, D, cuda_device, dtype=torch.float32)
    got = ta.flash_token_attention(q, k, v, bias)
    assert got.shape == (2, Nq, D) and got.is_contiguous()
    np.testing.assert_allclose(got.cpu().numpy(),
                               ta.token_attention_reference(q, k, v, bias).cpu().numpy(),
                               **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("Nq,Nk", [(200, 300), (5, 300), (130, 129)])
def test_kernel_query_and_key_counts(Nq, Nk, cuda_device):
    """B = 2 with Nk not a multiple of the 128-key tile (the batch edge:
    rows past N must not read the next batch's), and a query count under
    one tile; one launches increment per call."""
    q, k, v, bias = _bf16_case(12, 2, Nq, Nk, 256, cuda_device)
    before = ta.launches
    got = ta.flash_token_attention(q, k, v, bias)
    assert ta.launches == before + 1
    assert got.shape == (2, Nq, 256)
    _assert_bf16_close(got, ta.token_attention_reference(q, k, v, bias))


@pytest.mark.cuda
def test_kernel_one_key_tile_all_masked(cuda_device):
    """Keys 128..255 (one whole score tile) all masked, the other tiles not:
    that tile's weights vanish in the merge of the tiles' partial sums."""
    q, k, v, _ = _bf16_case(13, 1, 256, 384, 128, cuda_device)
    bias = torch.zeros((1, 384), device=cuda_device)
    bias[:, 128:256] = NEG_INF
    got = ta.flash_token_attention(q, k, v, bias)
    _assert_bf16_close(got, ta.token_attention_reference(q, k, v, bias))
    keep = torch.cat([torch.arange(128), torch.arange(256, 384)]).to(cuda_device)
    _assert_bf16_close(got, ta.token_attention_reference(q, k[:, keep].contiguous(),
                                                         v[:, keep].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [77, 300, 8])
def test_kernel_widths_through_the_aligned_copy(D, cuda_device):
    """D % 8 != 0 goes through the wrapper's zero-padded copy (scale from the
    true D, output sliced back); D = 8 is the narrowest width TMA takes."""
    q, k, v, bias = _bf16_case(14, 1, 150, 150, D, cuda_device)
    got = ta.flash_token_attention(q, k, v, bias)
    assert got.shape == (1, 150, D) and got.is_contiguous()
    _assert_bf16_close(got, ta.token_attention_reference(q, k, v, bias))


def _det_bias(B, L, n_valid, seed):
    """The sttn-det (9,5) key bias as ops/patch_attention.py builds it: each
    frame is 12 x 12 = 144 tokens; frames from n_valid on are padded slots
    (-1e9 for all their tokens), and tokens whose 9x5 patch lies mostly in
    the hole (rows 7-9, columns 2-10 of the frame's grid, plus a few drawn
    from the seed) are gated (-1e9), so keys that are both carry -2e9."""
    rng = np.random.default_rng(seed)
    gated = np.zeros((12, 12), bool)
    gated[7:10, 2:11] = True
    gated |= rng.random((12, 12)) < 0.05
    frame_bias = np.where(np.arange(L) < n_valid, 0.0, NEG_INF)[:, None]
    bias = frame_bias + np.where(gated.reshape(-1), NEG_INF, 0.0)[None, :]
    return torch.from_numpy(np.broadcast_to(bias.reshape(-1), (B, L * 144))
                            .astype(np.float32).copy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,n_valid", [(16, 13), (12, 9)], ids=["N=2304", "N=1728"])
def test_kernel_sttn_det_scale(dtype, L, n_valid, cuda_device):
    """STTN-det's (9,5) scale: D = 2880, N = L*144 (2304 for a 50-frame
    chunk; 1728, not a multiple of the 256-row score tile, for a short
    range's chunk), with the patch-gating bias on top of padded frames."""
    torch.backends.cuda.matmul.allow_tf32 = False
    N, D = L * 144, 2880
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, N, D)).astype(np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    bias = _det_bias(1, L, n_valid, 16).to(cuda_device)
    assert (bias <= 2 * NEG_INF).any() and (bias == 0).any()
    before = ta.launches
    got = ta.flash_token_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    want = ta.token_attention_reference(q, k, v, bias)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **F32_TOL)
    else:
        _assert_bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_on_another_card_keeps_current_device(dtype, cuda_device):
    """A launch for tensors on the last card leaves the calling thread's
    current device as it was (the launchers restore it on every return),
    and its result is right."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(cuda_device)
    q, k, v, bias = _inputs(9, (2, 300, 64), n_valid=200)
    q, k, v = (t.to(last, dtype) for t in (q, k, v))
    bias = bias.to(last)
    got = ta.flash_token_attention(q, k, v, bias)
    assert torch.cuda.current_device() == cuda_device.index
    assert got.device == last
    want = ta.token_attention_reference(q, k, v, bias)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_kernel_refuses_inputs_that_require_grad(cuda_device):
    """F6: the kernel is forward-only, so on the card a call on inputs that
    require grad, with grad mode on, raises before any launch; under
    no_grad it runs."""
    q, k, v, _ = (t.to(cuda_device) if t is not None else None for t in _inputs(10, (1, 64, 32)))
    q.requires_grad_(True)
    before = ta.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        ta.flash_token_attention(q, k, v)
    assert ta.launches == before
    with torch.no_grad():
        got = ta.flash_token_attention(q, k, v)
    assert ta.launches == before + 1
    torch.testing.assert_close(got, ta.token_attention_reference(q.detach(), k, v), **F32_TOL)


@pytest.mark.cuda
def test_sttn_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One STTN trainer step (sttn-auto geometry at 640x120, channel 32, one
    block, discriminator nf 8) from the same init and data on the card and
    on the CPU, fp32 with TF32 off: every loss within 1e-4 relative; the
    token-attention kernel is not launched (the trainer's plain route)."""
    from vsr_tpu_torch.inpaint.weights import init_random_
    from vsr_tpu_torch.models.discriminator import VideoDiscriminator
    from vsr_tpu_torch.models.sttn import STTNGenerator
    from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig, as_floats

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = STTNGenerator(variant="auto", channel=32, stack_num=1, use_kernel=False)
        init_random_(gen, 1)
        dis = VideoDiscriminator(nf=8, seed=2)
        init_random_(dis, 2)
        rng = np.random.default_rng(3)
        frames = rng.uniform(-1, 1, (1, 2, 120, 640, 3)).astype(np.float32)
        masks = np.zeros((1, 2, 120, 640, 1), np.float32)
        masks[:, :, 80:110, 100:540] = 1.0
        before = ta.launches
        losses = {}
        for dev in (cuda_device, torch.device("cpu")):
            trainer = STTNTrainer(TrainConfig(batch_size=1, sample_length=2),
                                  generator=copy.deepcopy(gen), discriminator=copy.deepcopy(dis),
                                  device=dev)
            losses[dev.type] = as_floats(trainer.step(frames, masks))
        assert ta.launches == before
        for k, want in losses["cpu"].items():
            assert losses["cuda"][k] == pytest.approx(want, rel=1e-4), k
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
