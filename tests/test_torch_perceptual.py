"""The port's VGG features, LPIPS and perceptual losses (models/vgg.py,
models/lpips.py, train/perceptual.py) against the JAX package's on the CPU,
from the same drawn flax params (no weights are downloaded): features and
losses within 1e-5 relative, the losses' gradients to the prediction within
1e-4 (the l1 criterion's in norm). The ProPainter GAN step with the LPIPS
term: tests/test_torch_train_lpips.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train import draw_params
from vsr_tpu.models.lpips import LPIPS as FlaxLPIPS
from vsr_tpu.models.vgg import VGGFeatures as FlaxVGG
from vsr_tpu.train import perceptual as jax_perceptual
from vsr_tpu_torch.convert.from_flax import lpips_state_dict_from_flax, vgg_state_dict_from_flax
from vsr_tpu_torch.models.lpips import LPIPS
from vsr_tpu_torch.models.vgg import VGGFeatures
from vsr_tpu_torch.train import perceptual

H, W = 32, 48
LAYERS = {"vgg16": ("conv1_2", "relu2_1", "pool3", "relu5_3"),
          "vgg19": ("relu1_1", "conv3_4", "relu4_4", "pool5")}


def images(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, H, W, 3)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def flax_vgg(layers, vgg_type, seed, **kw):
    module = FlaxVGG(tuple(layers), vgg_type=vgg_type, **kw)
    params = draw_params(jax.eval_shape(module.init, jax.random.PRNGKey(0), images(0, 1)), seed)
    port = VGGFeatures(tuple(layers), vgg_type, **kw)
    port.load_state_dict(vgg_state_dict_from_flax(params), strict=True)
    return module, params, port


def flax_lpips(seed):
    x = images(0, 1)
    params = draw_params(jax.eval_shape(FlaxLPIPS().init, jax.random.PRNGKey(0), x, x), seed)
    port = LPIPS()
    port.load_state_dict(lpips_state_dict_from_flax(params), strict=True)
    return params, port


@pytest.mark.parametrize("vgg_type", ["vgg16", "vgg19"])
@pytest.mark.parametrize("use_input_norm,range_norm", [(True, False), (False, True)])
def test_vgg_features_match(vgg_type, use_input_norm, range_norm):
    module, params, port = flax_vgg(LAYERS[vgg_type], vgg_type, 1,
                                    use_input_norm=use_input_norm, range_norm=range_norm)
    x = images(2)
    want = module.apply(params, jnp.asarray(x))
    got = port(nchw(x))
    assert list(got) == list(LAYERS[vgg_type])
    for name in LAYERS[vgg_type]:
        np.testing.assert_allclose(nhwc(got[name]), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_vgg_rejects_unknown_layers():
    with pytest.raises(ValueError, match="conv3_4"):
        VGGFeatures(("conv3_4",), "vgg16")


def test_lpips_matches():
    params, port = flax_lpips(3)
    x, y = images(4), images(5)
    want = FlaxLPIPS().apply(params, jnp.asarray(x), jnp.asarray(y))
    got = port(nchw(x), nchw(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("criterion,style_weight", [("l1", 0.0), ("mse", 0.5), ("fro", 2.0)])
def test_perceptual_loss_and_gradient_match(criterion, style_weight):
    weights = {"relu1_2": 0.5, "relu3_3": 1.0, "conv4_1": 0.25}
    module, params, port = flax_vgg(weights, "vgg19", 6, range_norm=True)
    pred, gt = images(7), images(8)

    def jax_loss(p):
        percep, style = jax_perceptual.perceptual_loss(
            params, p, jnp.asarray(gt), weights, vgg_type="vgg19", range_norm=True,
            perceptual_weight=1.5, style_weight=style_weight, criterion=criterion)
        return percep + (style if style is not None else 0.0), (percep, style)

    (_, (want_p, want_s)), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    got_p, got_s = perceptual.perceptual_loss(port, tp, nchw(gt), weights, perceptual_weight=1.5,
                                              style_weight=style_weight, criterion=criterion)
    assert got_p.item() == pytest.approx(float(want_p), rel=1e-5)
    if style_weight:
        assert got_s.item() == pytest.approx(float(want_s), rel=1e-5)
    else:
        assert got_s is None and want_s is None
    (got_p + (got_s if got_s is not None else 0.0)).backward()
    got_grad, want_grad = nhwc(tp.grad), np.asarray(want_grad)
    if criterion == "l1":
        # the gradient of |a - b| is sign(a - b): a feature equal up to
        # rounding may take either sign, so the l1 gradient is held in norm
        err = np.linalg.norm(got_grad - want_grad) / np.linalg.norm(want_grad)
        assert err < 1e-3, err
    else:
        np.testing.assert_allclose(got_grad, want_grad, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want_grad).max()))


def test_perceptual_loss_checks_layers():
    _, _, port = flax_vgg(("relu1_2",), "vgg16", 9)
    with pytest.raises(ValueError, match="relu2_2"):
        perceptual.perceptual_loss(port, nchw(images(1)), nchw(images(2)), {"relu2_2": 1.0})
    with pytest.raises(NotImplementedError):
        perceptual.perceptual_loss(port, nchw(images(1)), nchw(images(2)), {"relu1_2": 1.0},
                                   criterion="l3")


@pytest.mark.parametrize("use_input_norm,range_norm", [(True, True), (False, False)])
def test_lpips_loss_and_gradient_match(use_input_norm, range_norm):
    params, port = flax_lpips(10)
    pred, target = images(11), images(12)

    def jax_loss(p):
        return jax_perceptual.lpips_loss(params, p, jnp.asarray(target), loss_weight=0.7,
                                         use_input_norm=use_input_norm, range_norm=range_norm)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    tp = nchw(pred).requires_grad_(True)
    got = perceptual.lpips_loss(port, tp, nchw(target), loss_weight=0.7,
                                use_input_norm=use_input_norm, range_norm=range_norm)
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    got.backward()
    np.testing.assert_allclose(nhwc(tp.grad), np.asarray(want_grad), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want_grad).max()))


@pytest.mark.parametrize("convert,bad", [
    (vgg_state_dict_from_flax, {"conv6_1": {"kernel": np.zeros((3, 3, 1, 1))}}),
    (vgg_state_dict_from_flax, {"conv1_1": {"kernel_x": np.zeros(2)}}),
    (lpips_state_dict_from_flax, {"lin5": {"kernel": np.zeros((1, 1, 2, 1))}}),
    (lpips_state_dict_from_flax, {"net": {"conv5_4": {"kernel": np.zeros((3, 3, 1, 1))}}}),
])
def test_converters_reject_unknown_keys(convert, bad):
    with pytest.raises(KeyError):
        convert(bad)
