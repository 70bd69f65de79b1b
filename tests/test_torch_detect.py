"""The port's detector (vsr_tpu_torch/detect/) against the JAX package's on
the same inputs and the same params, carried by dbnet_state_dict_from_flax:
DBNet server at the tiny widths of tests/test_detect.py, layer by layer
(backbone, neck, head) and whole, within 1e-4 (fp32 both sides; measured
~1e-6); a ConvTranspose with an asymmetric kernel; and
SubtitleDetector.find_subtitle_frame_no on a small video, equal dicts."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from vsr_tpu.convert.params_io import save_params
from vsr_tpu.detect.dbnet import DBNet as FlaxDBNet
from vsr_tpu.detect.heads import DBBranchHead as FlaxBranch
from vsr_tpu_torch.convert.from_flax import dbnet_state_dict_from_flax
from vsr_tpu_torch.detect.dbnet import DBNet
from vsr_tpu_torch.detect.heads import DBBranchHead
from vsr_tpu_torch.inpaint.weights import init_random_, load_dbnet_weights

# tests/test_detect.py's tiny PPHGNetV2 stages:
# (in, mid, out, blocks, downsample, light, kernel, layer_num)
TINY_HG_STAGES = (
    (16, 8, 16, 1, False, False, 3, 2),
    (16, 8, 32, 1, True, False, 3, 2),
    (32, 8, 48, 1, True, True, 3, 2),
    (48, 8, 64, 1, True, True, 3, 2),
)
TINY = dict(preset="server", hg_stages=TINY_HG_STAGES, fpn_channels=32)
TOL = dict(rtol=1e-4, atol=1e-4)


def _variables(module, seed, *init_args):
    """The flax module's variable tree (shapes from jax.eval_shape, which
    compiles nothing) filled from a seed with numpy: LeCun-normal kernels,
    and BatchNorm statistics, scales and every bias drawn too, so BN folding
    and biases are exercised (flax's init leaves them at 1 / 0)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    flat = traverse_util.flatten_dict(shapes, sep="/")
    for k, a in flat.items():
        if k.endswith("/kernel"):
            fan_in = int(np.prod(a.shape[:-1]))
            flat[k] = rng.normal(0, 1, a.shape) / np.sqrt(fan_in)
        elif k.endswith("/var") or k.endswith("/scale"):
            flat[k] = rng.uniform(0.5, 1.5, a.shape)
        else:  # mean, bias
            flat[k] = rng.normal(0, 0.1, a.shape)
        flat[k] = flat[k].astype(np.float32)
    return traverse_util.unflatten_dict(flat, sep="/")


def _port(variables, **kw):
    model = DBNet(**kw)
    model.load_state_dict(dbnet_state_dict_from_flax(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny_pair():
    flax_model = FlaxDBNet(**TINY)
    variables = _variables(flax_model, 1, jnp.zeros((1, 64, 96, 3)))
    return flax_model, variables, _port(variables, **TINY)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _taps(mdl, images):
    feats = mdl.backbone(images)
    fused = mdl.neck(feats)
    return feats, fused, mdl.head(fused)


@pytest.mark.parametrize("layer", ["backbone", "neck", "head", "dbnet"])
def test_dbnet_matches_flax(tiny_pair, layer):
    """Each layer is fed the flax layer before it's output, so a failure
    names its own layer; "dbnet" is the whole forward, NHWC in and out."""
    flax_model, variables, model = tiny_pair
    x = np.random.default_rng(2).normal(0, 1, (2, 64, 96, 3)).astype(np.float32)
    feats, fused, prob = flax_model.apply(variables, jnp.asarray(x), method=_taps)
    with torch.no_grad():
        if layer == "backbone":
            got = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
            assert len(got) == 4
            for g, w in zip(got, feats):
                np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)
            return
        if layer == "neck":
            got = _nhwc(model.neck([torch.from_numpy(np.array(f)).permute(0, 3, 1, 2)
                                    for f in feats]))
            want = fused
        elif layer == "head":
            got = _nhwc(model.head(torch.from_numpy(np.array(fused)).permute(0, 3, 1, 2)))
            want = prob
        else:
            got = model(torch.from_numpy(x)).numpy()
            want = prob
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if layer != "neck":
        assert float(np.std(got)) > 1e-4  # a map with signal, not a constant


def test_conv_transpose_asymmetric_kernel():
    """The head's k2 s2 ConvTranspose with kernels whose four taps all
    differ: a kernel flipped or with I/O swapped in the conversion moves the
    output far past the tolerance (checked on a flipped copy)."""
    flax_head = FlaxBranch(in_channels=8)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 5, 7, 8)).astype(np.float32)
    variables = _variables(flax_head, 5, jnp.asarray(x))
    flat = traverse_util.flatten_dict(variables, sep="/")
    taps = np.array([[1.0, -2.0], [3.0, 0.5]], np.float32)[:, :, None, None]
    flat["params/conv2/kernel"] = (taps * rng.uniform(0.5, 1.5, (1, 1, 2, 2))).astype(np.float32)
    flat["params/conv3/kernel"] = (taps * rng.uniform(0.5, 1.5, (1, 1, 1, 2))).astype(np.float32)
    variables = traverse_util.unflatten_dict(flat, sep="/")
    want = np.asarray(flax_head.apply(variables, jnp.asarray(x)))

    def port_out(state):
        head = DBBranchHead(8)
        head.load_state_dict(state, strict=True)
        with torch.no_grad():
            return _nhwc(head.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)))

    state = dbnet_state_dict_from_flax(variables)
    assert state["conv2.weight"].shape == (2, 2, 2, 2)  # (I, O, kh, kw)
    assert state["conv3.weight"].shape == (2, 1, 2, 2)
    got = port_out(state)
    assert got.shape == (1, 20, 28, 1)
    np.testing.assert_allclose(got, want, **TOL)
    flipped = dict(state, **{"conv3.weight": state["conv3.weight"].flip(-1, -2)})
    assert np.abs(port_out(flipped) - want).max() > 1e-2


def test_converter_drops_thresh_and_rejects_unknown_keys():
    """head/thresh (training only, in converted Paddle checkpoints) is
    dropped by name; any other key the port has no place for raises."""
    base = {"params/head/binarize/conv1/kernel": np.zeros((3, 3, 8, 2), np.float32)}
    thresh = {"params/head/thresh/conv1/kernel": np.zeros((3, 3, 8, 2), np.float32),
              "batch_stats/head/thresh/conv_bn1/mean": np.zeros(2, np.float32)}
    assert list(dbnet_state_dict_from_flax({**base, **thresh})) == ["head.binarize.conv1.weight"]
    with pytest.raises(KeyError):
        dbnet_state_dict_from_flax({"params/head/binarize/conv1/weight": np.zeros(2)})
    with pytest.raises(KeyError):
        dbnet_state_dict_from_flax({"cache/head/x/kernel": np.zeros(2)})


def test_weights_npz_and_random_init(tmp_path, tiny_pair):
    """load_dbnet_weights reads the JAX package's .npz (save_params) into
    the port's model; without a checkpoint, BatchNorm gets flax's start
    values (scale 1, bias 0, mean 0, var 1) and convs a seeded draw."""
    _, variables, model = tiny_pair
    path = str(tmp_path / "dbnet.npz")
    save_params(path, variables)
    loaded = DBNet(**TINY)
    load_dbnet_weights(loaded, path)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    a, b = DBNet(**TINY), DBNet(**TINY)
    for m in (a, b):
        for p in m.parameters():
            p.data.normal_()
        init_random_(m, seed=3)
    bn = a.backbone.stem.stem1.bn
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.bias, torch.zeros_like(bn.bias))
    assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert torch.equal(a.head.binarize.conv3.bias, torch.zeros(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.backbone.stem.stem1.conv.weight.std() > 0


def test_mobile_preset_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 6"):
        DBNet(preset="mobile")


# ---- the detector on a small video ----

BAR = (70, 86, 20, 110)  # y0, y1, x0, x1 of the white "subtitle" bar
NO_BAR = range(7, 11)  # frames (1-based) without it


def _write_video(path, n=14, h=96, w=128):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
    rng = np.random.default_rng(6)
    for i in range(1, n + 1):
        frame = np.full((h, w, 3), 30, np.uint8)
        frame += rng.integers(0, 2, frame.shape, dtype=np.uint8)
        if i not in NO_BAR:
            y0, y1, x0, x1 = BAR
            dx = i % 3  # a little jitter for unify_regions to snap
            frame[y0:y1, x0 + dx:x1 + dx] = 235
        writer.write(frame)
    writer.release()


def _calibrated(flax_model, variables, frame):
    """Even out the head's deconv taps, then rescale the two output convs
    (binarize/conv3, cbn_layer/last_1) so their logits read +4 inside the
    bar and -4 on the background of
    ``frame``: the random network then maps text-like bars to text-like
    probabilities, and the detector finds boxes. Both packages get the
    result, so this only chooses the params both are tested with."""
    from vsr_tpu.detect.preprocess import preprocess_frame

    x = jnp.asarray(preprocess_frame(frame)[None])
    h, w = x.shape[1:3]
    sy, sx = h / frame.shape[0], w / frame.shape[1]
    y0, y1, x0, x1 = BAR
    inside = (slice(int((y0 + 4) * sy), int((y1 - 4) * sy)),
              slice(int((x0 + 8) * sx), int((x1 - 8) * sx)))
    outside = (slice(int(10 * sy), int(40 * sy)), slice(int(10 * sx), int(118 * sx)))
    flat = traverse_util.flatten_dict(variables, sep="/")
    # the head's two k2 s2 deconvs with four equal taps: upsampling without
    # the 2x2 pattern that different taps stamp on the map
    for name in ("head/binarize/conv2", "head/binarize/conv3"):
        k = flat[f"params/{name}/kernel"]
        flat[f"params/{name}/kernel"] = np.broadcast_to(
            k.mean(axis=(0, 1), keepdims=True), k.shape).astype(np.float32)
    for name in ("head/binarize/conv3", "head/cbn_layer/last_1"):
        _, state = flax_model.apply(traverse_util.unflatten_dict(flat, sep="/"), x,
                                    capture_intermediates=True, mutable=["intermediates"])
        tree = state["intermediates"]
        for part in name.split("/"):
            tree = tree[part]
        z = np.asarray(tree["__call__"][0])[0, ..., 0]
        z_in, z_out = np.median(z[inside]), np.median(z[outside])
        assert abs(z_in - z_out) > 1e-3, (name, z_in, z_out)
        s = 8.0 / (z_in - z_out)
        bias = flat[f"params/{name}/bias"]
        flat[f"params/{name}/kernel"] = (flat[f"params/{name}/kernel"] * s).astype(np.float32)
        flat[f"params/{name}/bias"] = (
            s * (bias - (z_in + z_out) / 2)).astype(np.float32)
    return traverse_util.unflatten_dict(flat, sep="/")


@pytest.fixture(scope="module")
def detector_case(tmp_path_factory):
    d = tmp_path_factory.mktemp("det")
    video = str(d / "v.mp4")
    _write_video(video)
    cap = cv2.VideoCapture(video)
    _, frame = cap.read()
    cap.release()
    flax_model = FlaxDBNet(**TINY)
    variables = _variables(flax_model, 24, jnp.zeros((1, 64, 96, 3)))
    ckpt = str(d / "dbnet.npz")
    save_params(ckpt, _calibrated(flax_model, variables, frame))
    return video, ckpt


def _detectors(video, ckpt, **kw):
    from vsr_tpu.detect.detector import SubtitleDetector as JaxDetector
    from vsr_tpu_torch.detect.detector import SubtitleDetector

    jax_det = JaxDetector(video, checkpoint_path=ckpt, batch_size=4, **kw)
    jax_det._model = FlaxDBNet(**TINY)
    det = SubtitleDetector(video, checkpoint_path=ckpt, batch_size=4, device="cpu", **kw)
    det._model = DBNet(**TINY)
    return jax_det, det


@pytest.mark.parametrize("sub_areas", [None, [(40, 96, 0, 128)], [(0, 50, 0, 128)]],
                         ids=["whole frame", "bottom area", "top area"])
def test_find_subtitle_frame_no_matches_jax(detector_case, sub_areas):
    """24 fps: every 2nd frame sampled, batches of 4 (the JAX detector pads
    the last one, the port does not), gaps filled, boxes unified: the port's
    dict equals the JAX package's, and finds the bar on its frames."""
    video, ckpt = detector_case
    jax_det, det = _detectors(video, ckpt, sub_areas=sub_areas)
    assert det.sample_step == jax_det.sample_step == 2
    want = jax_det.find_subtitle_frame_no()
    got = det.find_subtitle_frame_no()
    assert got == want
    if sub_areas == [(0, 50, 0, 128)]:
        assert got == {}
        return
    # the bar is found on the sampled frames that show it, and only there
    # (the random network also marks a corner of the frame on some samples)
    for frame_no in range(1, 15, det.sample_step):
        assert any(_covers_bar(b) for b in got.get(frame_no, [])) == (
            frame_no not in NO_BAR), (frame_no, got.get(frame_no))


def _covers_bar(box):
    xmin, xmax, ymin, ymax = box
    y0, y1, x0, x1 = BAR
    return xmin <= x0 + 4 and xmax >= x1 - 4 and ymin <= y0 + 4 and ymax >= y1 - 4


def test_detect_subtitle_matches_jax(detector_case):
    """One picture through detect_subtitle, and the probability map itself."""
    video, ckpt = detector_case
    jax_det, det = _detectors(video, ckpt)
    cap = cv2.VideoCapture(video)
    _, frame = cap.read()
    cap.release()
    assert det.detect_subtitle(frame) == jax_det.detect_subtitle(frame)
    from vsr_tpu_torch.detect.preprocess import preprocess_frame

    batch = preprocess_frame(frame)[None]
    jax_det._ensure_params(batch[0])
    want = np.asarray(jax_det._forward(jax_det._params, jnp.asarray(batch)))
    np.testing.assert_allclose(det.probability_maps(batch), want, **TOL)


def test_detector_cuda_without_gpu_raises(detector_case):
    from vsr_tpu_torch.detect.detector import SubtitleDetector

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SubtitleDetector(detector_case[0])
