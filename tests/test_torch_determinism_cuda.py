"""Run-to-run determinism of the port's training ops on the card.

The STTN decoder's align-corners 2x upsample
(vsr_tpu_torch/ops/upsample.py) has PyTorch's upsample_bilinear2d_backward
as its backward, which sums with atomic adds on CUDA: two runs on the same
input and gradient differ in the last bits, and Adam (beta1 0) grows that
into STTN training runs that part (scripts/train_divergence.py). Under
torch.use_deterministic_algorithms(True) PyTorch takes a deterministic
path for it and one process repeats bit for bit. This file holds that
route. It imports no jax (the repo's conftest does, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_determinism_cuda.py -q

Here, without a card, the tests skip.
"""

import pytest
import torch

from vsr_tpu_torch.ops.upsample import upsample_bilinear_2x_align_corners


@pytest.fixture
def deterministic_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda", 0)
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 256, 30, 160), (40, 64, 60, 320)],
                         ids=["decoder-in", "decoder-mid"])
def test_upsample_backward_repeats_under_deterministic_algorithms(deterministic_cuda, shape):
    """The decoder's two upsample inputs at a TrainConfig() batch (8 x 5
    frames of 640x120): the input gradient of two backward runs is equal
    bit for bit."""
    gen = torch.Generator(deterministic_cuda).manual_seed(0)
    x = torch.randn(shape, device=deterministic_cuda, generator=gen, requires_grad=True)
    y = upsample_bilinear_2x_align_corners(x)
    g = torch.randn(y.shape, device=deterministic_cuda, generator=gen)
    first, second = (torch.autograd.grad(y, x, g, retain_graph=True)[0] for _ in range(2))
    torch.testing.assert_close(first, second, rtol=0, atol=0)
