"""Run-to-run determinism of the port's training ops on the card.

The STTN decoder's align-corners 2x upsample
(vsr_tpu_torch/ops/upsample.py) once had PyTorch's
upsample_bilinear2d_backward as its backward, which sums with atomic adds
on CUDA: two runs on the same input and gradient differed in the last bits,
and Adam (beta1 0) grew that into STTN training runs that part
(scripts/train_divergence.py). Its backward is now two matmuls with the
interpolation matrices, so it repeats bit for bit by itself; under
torch.use_deterministic_algorithms(True) too. This file holds both. It
imports no jax (the repo's conftest does, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_determinism_cuda.py -q

Here, without a card, the tests skip.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import pytest
import torch

from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners


SHAPES = [(40, 256, 30, 160), (40, 64, 60, 320)]
IDS = ["decoder-in", "decoder-mid"]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    return torch.device("cuda", 0)


def _two_backward_runs(dev, shape):
    """The input gradient of the upsample, twice, from one seeded input and
    output gradient."""
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(shape, device=dev, generator=gen, requires_grad=True)
    y = upsample_bilinear_2x_align_corners(x)
    g = torch.randn(y.shape, device=dev, generator=gen)
    return [torch.autograd.grad(y, x, g, retain_graph=True)[0] for _ in range(2)]


@pytest.fixture
def deterministic_cuda(monkeypatch):
    """Deterministic algorithms on; cuBLAS then needs its workspace setting,
    or PyTorch refuses the backward's matmuls."""
    dev = _cuda()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield dev
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_upsample_backward_repeats_under_deterministic_algorithms(deterministic_cuda, shape):
    """The decoder's two upsample inputs at a TrainConfig() batch (8 x 5
    frames of 640x120): the input gradient of two backward runs is equal
    bit for bit."""
    first, second = _two_backward_runs(deterministic_cuda, shape)
    torch.testing.assert_close(first, second, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_upsample_backward_repeats_without_deterministic_algorithms(shape):
    """The same, with PyTorch's deterministic algorithms off (its default):
    the matmul backward needs no global flag."""
    dev = _cuda()
    assert not torch.are_deterministic_algorithms_enabled()
    first, second = _two_backward_runs(dev, shape)
    torch.testing.assert_close(first, second, rtol=0, atol=0)
