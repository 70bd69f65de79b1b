"""The ProPainter GAN step with the LPIPS term (perceptual_weight 0.1, the
port's LPIPS on the drawn flax params) against ``make_propainter_train_step``
on the CPU: the check of tests/test_torch_train_propainter.py, which runs
the step without the term. A file of its own, so that each file's JAX
compiles stay near half a minute."""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
from tests.test_torch_train_propainter import check_gan_step, gan_setup  # noqa: F401


def test_gan_step_with_lpips_matches_jax(gan_setup):  # noqa: F811
    check_gan_step(gan_setup, 0.1)
