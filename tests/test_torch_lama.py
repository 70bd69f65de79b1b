"""The port's LaMa (vsr_tpu_torch/models/lama.py, inpaint/lama.py) against
the JAX package's on the same numpy inputs and the same params, carried by
lama_state_dict_from_flax, in fp32 on the CPU:

* FourierUnit against flax's at fft_impl "matmul" and "xla", odd and even
  widths, within 1e-5;
* the tiny generator of tests/test_lama.py (ngf 8, 2 downsamples, 2
  blocks), stage by stage and whole, within 1e-4;
* out_rows: sliced rows bit-identical to the port's full forward, and
  within 1e-4 of flax's sliced output, interior and clamped offsets;
* big-lama's key names: tests/reference_compat.build_torch_lama at full
  width -> vsr_tpu's convert_lama_state_dict -> lama_state_dict_from_flax
  -> a strict load into the port, output within 1e-4 of the torch net;
* LamaInpainter.inpaint / inpaint_batch / __call__ against vsr_tpu's under
  VSR_LAMA_H2D=bgr, VSR_LAMA_BAND_D2H=bgr, VSR_LAMA_BUCKET=8: frames within
  1 uint8, outside the mask bit-identical to the input.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import traverse_util

from tests.test_torch_detect import _variables
from vsr_tpu.convert.params_io import save_params
from vsr_tpu.models.lama import FourierUnit as FlaxFourierUnit
from vsr_tpu.models.lama import LamaGenerator as FlaxLama
from vsr_tpu_torch.convert.from_flax import lama_state_dict_from_flax
from vsr_tpu_torch.inpaint.weights import load_lama_weights
from vsr_tpu_torch.models.lama import FourierUnit, LamaGenerator

TINY = dict(ngf=8, n_downsampling=2, n_blocks=2)
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_U8 = 1


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _image_and_mask(seed, b=2, h=64, w=48):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    msk = np.zeros((b, h, w, 1), np.float32)
    msk[:, h // 2 - 10:h // 2 + 10, 8:w - 8] = 1.0
    return img, msk


@pytest.mark.parametrize("fft_impl", ["matmul", "xla"])
@pytest.mark.parametrize("hw", [(16, 24), (12, 9)], ids=["even-width", "odd-width"])
def test_fourier_unit_matches_flax(fft_impl, hw):
    """rfft2 -> (re, im) channel-major 1x1 conv, BN, ReLU -> irfft2: the
    spectral layout and the odd width's Hermitian bins as flax has them."""
    x = np.random.default_rng(1).normal(0, 1, (2, *hw, 8)).astype(np.float32)
    flax_fu = FlaxFourierUnit(6, fft_impl=fft_impl)
    variables = _variables(flax_fu, 2, jnp.asarray(x))
    want = np.asarray(flax_fu.apply(variables, jnp.asarray(x)))
    # the converter takes the generator's module paths: nest the unit there
    prefix = "block0/conv1/ffc/g2g/fu"
    nested = {f"{c}/{prefix}/{k}": v for c, tree in variables.items()
              for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
    state = {k[len(prefix) + 1:]: v for k, v in lama_state_dict_from_flax(nested).items()}
    fu = FourierUnit(8, 6)
    fu.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = _nhwc(fu.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (2, *hw, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_pair():
    flax_model = FlaxLama(**TINY)
    variables = _variables(flax_model, 3, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 1)))
    model = LamaGenerator(**TINY)
    model.load_state_dict(lama_state_dict_from_flax(variables), strict=True)
    return flax_model, variables, model.eval()


STAGES = ["stem", "down0", "down1", "block0", "block1", "up0", "up1", "head"]


@pytest.mark.parametrize("stage", STAGES + ["generator"])
def test_generator_matches_flax(tiny_pair, stage):
    """Each stage's output (forward hooks on the port's module of the same
    name, flax's captured intermediates), and the whole forward."""
    flax_model, variables, model = tiny_pair
    img, msk = _image_and_mask(4)
    want, state = flax_model.apply(variables, jnp.asarray(img), jnp.asarray(msk),
                                   capture_intermediates=True, mutable=["intermediates"])
    if stage == "generator":
        with torch.no_grad():
            got = model(torch.from_numpy(img), torch.from_numpy(msk)).numpy()
        assert got.shape == (2, 64, 48, 3)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        return
    captured = []
    hook = model.get_submodule(stage).register_forward_hook(
        lambda m, i, o: captured.append(o))
    try:
        with torch.no_grad():
            model(torch.from_numpy(img), torch.from_numpy(msk))
    finally:
        hook.remove()
    got = captured[0] if isinstance(captured[0], tuple) else (captured[0],)
    flax_out = state["intermediates"][stage]["__call__"][0]
    flax_out = flax_out if isinstance(flax_out, tuple) else (flax_out,)
    assert len(got) == len(flax_out)
    for g, w in zip(got, flax_out):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("r0", [0, 1, 7, 9, 20, 32])
def test_out_rows_match_full_forward(tiny_pair, r0):
    """Rows [r0, r0 + 32) of a 64-row output: bit-identical to the port's
    full forward, and within 1e-4 of flax's out_rows output. r0 = 0 and
    r0 = 32 clamp the half-resolution slice at the image's edges."""
    flax_model, variables, model = tiny_pair
    img, msk = _image_and_mask(5, b=1)
    with torch.no_grad():
        full = model(torch.from_numpy(img), torch.from_numpy(msk)).numpy()
        rows = model(torch.from_numpy(img), torch.from_numpy(msk), out_rows=(r0, 32)).numpy()
    assert rows.shape == (1, 32, 48, 3)
    np.testing.assert_array_equal(rows, full[:, r0:r0 + 32])
    want = np.asarray(flax_model.apply(variables, jnp.asarray(img), jnp.asarray(msk),
                                       out_rows=(jnp.int32(r0), 32)))
    np.testing.assert_allclose(rows, want, **TOL)


def test_big_lama_chain_matches_torch():
    """big-lama's structure and key names at full width (ngf 64, 3
    downsamples, 18 blocks), BatchNorm statistics drawn so that a swapped
    mean/var or scale/bias would show: torch net -> vsr_tpu's
    convert_lama_state_dict -> lama_state_dict_from_flax -> strict load into
    the port; on a 64x64 input the two nets agree within 1e-4."""
    from tests.reference_compat import build_torch_lama
    from vsr_tpu.convert.torch_lama import convert_lama_state_dict

    gen = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    ref = build_torch_lama()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0, 0.1, generator=gen)
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    ref.eval()
    port = LamaGenerator()
    port.load_state_dict(lama_state_dict_from_flax(convert_lama_state_dict(ref.state_dict())),
                         strict=True)
    img, msk = _image_and_mask(6, b=1, h=64, w=64)
    x4 = np.concatenate([img * (1.0 - msk), msk], axis=-1)
    with torch.no_grad():
        want = _nhwc(ref(torch.from_numpy(x4).permute(0, 3, 1, 2)))
        got = port.eval()(torch.from_numpy(img), torch.from_numpy(msk)).numpy()
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, **TOL)
    assert float(np.std(got)) > 1e-3


def test_converter_rejects_unknown_keys():
    ok = {"params/up0/kernel": np.zeros((3, 3, 2, 4), np.float32)}
    assert lama_state_dict_from_flax(ok)["up0.weight"].shape == (4, 2, 3, 3)  # (I, O, kh, kw)
    for bad in ({"params/up0/scale_x": np.zeros(2, np.float32)},
                {"params/block0/conv1/ffc/g2g/fu/conv3/kernel": np.zeros(2, np.float32)},
                {"params/encoder/kernel": np.zeros(2, np.float32)},
                {"cache/head/kernel": np.zeros(2, np.float32)}):
        with pytest.raises(KeyError):
            lama_state_dict_from_flax(bad)


def test_load_lama_weights(tmp_path, tiny_pair):
    """.npz (the JAX package's save_params) loads bit for bit; a .pth
    raises; no checkpoint: seeded init with flax's BatchNorm start values."""
    _, variables, model = tiny_pair
    path = str(tmp_path / "lama.npz")
    save_params(path, variables)
    loaded = LamaGenerator(**TINY)
    load_lama_weights(loaded, path)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    pth = tmp_path / "big-lama.pt"
    pth.write_bytes(b"")
    with pytest.raises(ValueError, match="convert to .npz"):
        load_lama_weights(LamaGenerator(**TINY), str(pth))
    a, b = LamaGenerator(**TINY), LamaGenerator(**TINY)
    for m in (a, b):
        load_lama_weights(m, None, seed=3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    bn = a.block0.conv1.ffc.g2g.fu.bn
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert torch.equal(a.head.bias, torch.zeros(3))
    assert a.stem.weight.std() > 0


# ---- LamaInpainter against vsr_tpu's ----


@pytest.fixture(scope="module")
def lama_ckpt(tmp_path_factory, tiny_pair):
    path = str(tmp_path_factory.mktemp("lama") / "lama.npz")
    save_params(path, tiny_pair[1])
    return path


@pytest.fixture
def inpainters(lama_ckpt, monkeypatch):
    """Both packages' LamaInpainter on the tiny generator, fp32, the same
    .npz; vsr_tpu under its exact-BGR, mod-8 settings."""
    from vsr_tpu.config import Config as JaxConfig
    from vsr_tpu.inpaint import lama as jmod
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint import lama as tmod

    for var in ("VSR_LAMA_H2D", "VSR_LAMA_BAND_D2H"):
        monkeypatch.setenv(var, "bgr")
    monkeypatch.setenv("VSR_LAMA_BUCKET", "8")
    monkeypatch.setattr(jmod, "LamaGenerator", lambda **kw: FlaxLama(**{**kw, **TINY}))
    monkeypatch.setattr(tmod, "LamaGenerator", lambda **kw: LamaGenerator(**{**kw, **TINY}))
    return (jmod.LamaInpainter(lama_ckpt, JaxConfig(compute_dtype="float32")),
            tmod.LamaInpainter(lama_ckpt, Config(compute_dtype="float32"), device="cpu"))


def _u8_close(want, got):
    want, got = np.asarray(want).astype(int), np.asarray(got).astype(int)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= MAX_U8, (diff.max(), int((diff > 0).sum()))
    return int((diff > 0).sum())


def test_inpaint_picture_matches_jax(inpainters):
    """One 75x131 image (padded to 80x136 by symmetric reflection, cropped
    back): the whole model output, within 1 uint8 of vsr_tpu's (equal,
    measured)."""
    jax_inp, inp = inpainters
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (75, 131, 3), dtype=np.uint8)
    mask = np.zeros((75, 131), np.uint8)
    mask[40:60, 20:110] = 255
    got = inp.inpaint(img, mask)
    assert got.shape == img.shape and got.dtype == np.uint8
    _u8_close(jax_inp.inpaint(img, mask), got)
    assert np.abs(got.astype(int) - img.astype(int))[mask > 0].mean() > 1


def test_inpaint_batch_matches_jax(inpainters):
    """Six images: a batch of 4 and a tail of 2 padded to 4."""
    jax_inp, inp = inpainters
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (40, 56, 3), dtype=np.uint8) for _ in range(6)]
    masks = [np.zeros((40, 56), np.uint8) for _ in range(6)]
    for i, m in enumerate(masks):
        m[10 + i:20 + i, 8:40] = 255
    got = inp.inpaint_batch(imgs, masks)
    assert len(got) == 6
    for w, g in zip(jax_inp.inpaint_batch(imgs, masks), got):
        _u8_close(w, g)


def test_band_path_matches_jax(inpainters):
    """23 frames of 160x448 (a batch of 16 and a tail of 7 padded with its
    last frame), a mask in two islands 100 rows apart: two bands of
    split_h = 448*3/16 = 84 rows (padded to 88), each returning 64 rows
    from r0 > 0 through out_rows. Within 1 uint8 of vsr_tpu's frames (2 of
    4,945,920 values differ, by 1, measured), outside the mask bit-identical
    to the input, inside changed."""
    from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

    jax_inp, inp = inpainters
    base = np.random.default_rng(9).integers(0, 256, (160, 448, 3), dtype=np.uint8)
    frames = [np.roll(base, 5 * i, axis=1).copy() for i in range(23)]
    mask = np.zeros((160, 448), np.uint8)
    mask[20:30, 40:400] = 255
    mask[120:131, 60:380] = 255
    bands = get_inpaint_area_by_mask(448, 160, 84, mask[:, :, None])
    assert len(bands) == 2
    geometry = [inp.band_geometry(mask[:, :, None], b[0], b[1]) for b in bands]
    assert all(out_h == 64 for _, out_h in geometry) and any(r0 > 0 for r0, _ in geometry)
    got = inp([f.copy() for f in frames], mask)
    want = jax_inp([f.copy() for f in frames], mask)
    assert len(got) == 23
    _u8_close(np.stack(want), np.stack(got))
    src = np.stack(frames).astype(int)
    got = np.stack(got).astype(int)
    outside = np.broadcast_to((mask == 0)[None, :, :, None], src.shape)
    np.testing.assert_array_equal(got[outside], src[outside])
    assert np.abs(got - src)[~outside].mean() > 1


def test_band_path_empty_mask_identity(inpainters):
    _, inp = inpainters
    frames = [np.full((96, 128, 3), 77, np.uint8) for _ in range(3)]
    out = inp(frames, np.zeros((96, 128), np.uint8))
    assert len(out) == 3
    for a, b in zip(out, frames):
        np.testing.assert_array_equal(a, b)
        assert a is not b
