"""The port's flow losses (vsr_tpu_torch/train/flow_losses.py) against the JAX
package's on the CPU, on the same numpy inputs, within 1e-6: first- and
second-order smoothness, the census (ternary) loss, and flow_warp_loss,
whose warp is the port's ops/grid_sample.flow_warp. The masks are random,
so the smoothness terms see holes, and the flows smooth and a few pixels
large, so the warp samples between pixels and outside the frame."""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vsr_tpu.train import flow_losses as jax_fl
from vsr_tpu_torch.train import flow_losses

B, H, W = 2, 20, 28
TOL = 1e-6


def inputs(seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 3, (B, 2, H // 4, W // 4)).astype(np.float32)
    flow = torch.nn.functional.interpolate(torch.from_numpy(base), size=(H, W), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1).numpy()
    mask = (rng.uniform(size=(B, H, W, 1)) > 0.3).astype(np.float32)
    frame1, frame2 = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    return flow, mask, frame1, frame2


def both(name, *args, **kw):
    want = float(getattr(jax_fl, name)(*map(jnp.asarray, args), **kw))
    got = getattr(flow_losses, name)(*map(torch.from_numpy, args), **kw)
    assert got.shape == ()
    return float(got), want


@pytest.mark.parametrize("name", ["smoothness_loss", "second_order_smoothness_loss"])
def test_smoothness_matches(name):
    flow, mask, _, _ = inputs(0)
    got, want = both(name, flow, mask)
    assert want > 0
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


@pytest.mark.parametrize("patch", [7, 3])
def test_ternary_loss_matches(patch):
    _, mask, frame1, frame2 = inputs(1)
    got, want = both("ternary_loss", frame1, frame2, mask, patch=patch)
    assert want > 0
    assert got == pytest.approx(want, rel=TOL, abs=TOL)
    # identical frames: no census distance
    same, _ = both("ternary_loss", frame1, frame1, mask, patch=patch)
    assert same == 0.0


def test_flow_warp_loss_matches():
    flow, mask, frame1, frame2 = inputs(2)
    got, want = both("flow_warp_loss", frame1, frame2, flow, mask)
    assert want > 0
    assert got == pytest.approx(want, rel=TOL, abs=TOL)


def test_losses_have_gradients():
    flow, mask, frame1, frame2 = inputs(3)
    f = torch.from_numpy(flow).requires_grad_(True)
    loss = (flow_losses.smoothness_loss(f, torch.from_numpy(mask))
            + flow_losses.second_order_smoothness_loss(f, torch.from_numpy(mask))
            + flow_losses.flow_warp_loss(*map(torch.from_numpy, (frame1, frame2)), f,
                                         torch.from_numpy(mask)))
    loss.backward()
    assert torch.isfinite(f.grad).all() and f.grad.abs().max() > 0
