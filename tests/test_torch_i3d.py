"""The port's I3D (vsr_tpu_torch/models/i3d.py) and VFID against the JAX
package's on the CPU, from the same drawn flax variables (moved by
``i3d_state_dict_from_flax``): pooled features and logits within
1e-4 * (1 + |ref|) at [1, 9, 64, 64, 3] (tests/test_metrics.py's clip), on an
all-negative clip and on odd T / H / W (the SAME pads' extra pixel at the
back); VFID within 1e-4 relative with each package's I3D; and a
reference-format state dict (the i3d_rgb_imagenet.pt layout, its 1x1x1
logits conv included) loading strict into the port's module as the
converter + from_flax route does. The JAX forward compiles once per shape
(a module fixture)."""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from tests.test_torch_train import draw_params
from vsr_tpu.models.i3d import InceptionI3d as FlaxI3D
from vsr_tpu.utils.metrics import vfid as jax_vfid
from vsr_tpu_torch.convert.from_flax import i3d_state_dict_from_flax
from vsr_tpu_torch.convert.torch_i3d import convert_i3d_state_dict
from vsr_tpu_torch.models.i3d import InceptionI3d
from vsr_tpu_torch.utils.metrics import vfid

CLIP = (1, 9, 64, 64, 3)
ODD_CLIP = (1, 11, 37, 45, 3)
TOL = 1e-4
# flax I3D module -> the reference checkpoint's (convert/torch_i3d.py's rules inverted)
_REF_NAMES = {"conv1a": "Conv3d_1a_7x7", "conv2b": "Conv3d_2b_1x1", "conv2c": "Conv3d_2c_3x3",
              "b3": "b3b", "conv": "conv3d"}


def clip(seed, shape=CLIP):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def draw_i3d(seed):
    """Flax InceptionI3d variables with the logits head: draw_params, BN
    scales near 1, running means N(0, 0.1) and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda r: FlaxI3D().init(r, jnp.zeros(CLIP), features_only=False),
                            jax.random.PRNGKey(0))
    params = traverse_util.flatten_dict(draw_params(shapes["params"], seed), sep="/")
    params = {k: (1 + v).astype(np.float32) if k.endswith("scale") else v
              for k, v in params.items()}
    rng = np.random.default_rng(seed + 1)
    stats = {k: (rng.uniform(0.5, 1.5, a.shape) if k.endswith("var")
                 else rng.normal(0, 0.1, a.shape)).astype(np.float32)
             for k, a in traverse_util.flatten_dict(shapes["batch_stats"], sep="/").items()}
    return {"params": traverse_util.unflatten_dict(params, sep="/"),
            "batch_stats": traverse_util.unflatten_dict(stats, sep="/")}


def i3d_reference_shapes():
    """{key: shape} of i3d_rgb_imagenet.pt (the reference's InceptionI3d(400)
    state dict), derived from the flax module's shapes."""
    shapes = jax.eval_shape(lambda r: FlaxI3D().init(r, jnp.zeros(CLIP), features_only=False),
                            jax.random.PRNGKey(0))
    spec = {}
    for path, a in traverse_util.flatten_dict(shapes["params"], sep="/").items():
        *module, leaf = path.split("/")
        if module == ["logits"]:
            spec[f"logits.conv3d.{'weight' if leaf == 'kernel' else 'bias'}"] = \
                a.shape[::-1] + (1, 1, 1) if leaf == "kernel" else a.shape
            continue
        name = ".".join(_REF_NAMES.get(p, p.capitalize() if p.startswith("mixed_") else p)
                        for p in module)
        if leaf == "kernel":
            d, h, w, i, o = a.shape
            spec[f"{name}.weight"] = (o, i, d, h, w)
        elif leaf == "scale":
            c = a.shape[0]
            for bn_leaf in ("weight", "bias", "running_mean", "running_var"):
                spec[f"{name}.{bn_leaf}"] = (c,)
            spec[f"{name}.num_batches_tracked"] = ()
    return spec


def reference_state_dict(seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in i3d_reference_shapes().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def i3d():
    """(jitted flax apply returning (features, logits), variables, port model)."""
    variables = draw_i3d(1)
    module = FlaxI3D()
    fn = jax.jit(lambda v, x: (module.apply(v, x), module.apply(v, x, features_only=False)))
    model = InceptionI3d().eval()
    model.load_state_dict(i3d_state_dict_from_flax(variables), strict=True)
    return fn, variables, model


def check(i3d, x):
    fn, variables, model = i3d
    want_f, want_l = (np.asarray(a) for a in fn(variables, jnp.asarray(x)))
    with torch.no_grad():
        got_f = model(torch.from_numpy(x)).numpy()
        got_l = model(torch.from_numpy(x), features_only=False).numpy()
    assert got_f.shape == (x.shape[0], 1024) and got_l.shape == (x.shape[0], 400)
    for got, want in ((got_f, want_f), (got_l, want_l)):
        assert np.all(np.abs(got - want) <= TOL * (1 + np.abs(want)))
    assert np.abs(want_f).max() > 1e-2  # the features carry signal
    return want_f


def test_features_and_logits_match(i3d):
    check(i3d, clip(0))


def test_all_negative_clip_matches(i3d):
    """Every input below zero: the max pools' zero padding (not -inf)."""
    check(i3d, -np.abs(clip(1)) - 0.1)


def test_odd_sizes_match(i3d):
    """Odd T / H / W: SAME pads that are odd put the extra pixel at the back."""
    check(i3d, clip(2, ODD_CLIP))


def test_vfid_matches(i3d):
    """VFID of two sets of 8 clips, each package's metric with its own I3D
    (clip by clip, at the fixture's compiled shape)."""
    fn, variables, model = i3d

    def jax_apply(videos):
        return np.concatenate([np.asarray(fn(variables, jnp.asarray(v[None]))[0])
                               for v in videos])

    def port_apply(videos):
        with torch.no_grad():
            return model(torch.from_numpy(videos))

    real = np.stack([clip(10 + i)[0] for i in range(8)])
    fake = np.clip(real + np.random.default_rng(3).normal(0, 0.3, real.shape), -1, 1)
    fake = fake.astype(np.float32)
    want = jax_vfid(real, fake, jax_apply)
    got = vfid(real, fake, port_apply)
    assert want > 0
    assert got == pytest.approx(want, rel=TOL)


def test_reference_state_dict_loads_strict():
    """An i3d_rgb_imagenet.pt-layout state dict loads strict into the port's
    module, its 1x1x1 logits conv into the Linear, and gives the weights
    that the converter + from_flax route gives."""
    sd = reference_state_dict()
    assert len(sd) == 344
    direct = InceptionI3d()
    direct.load_state_dict(sd, strict=True)
    via = InceptionI3d()
    via.load_state_dict(i3d_state_dict_from_flax(convert_i3d_state_dict(sd)), strict=True)
    a, b = direct.state_dict(), via.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(KeyError, match="I3D"):
        i3d_state_dict_from_flax({"params": {"conv9": {"conv": {"kernel": np.zeros((1,) * 5)}}}})
