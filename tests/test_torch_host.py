"""The port's own copies of the JAX package's host modules (config, masks,
interval algebra, detection pre- and post-processing, native host ops,
i18n, cli parser), held against ``vsr_tpu``'s on the same inputs, made from
a seed with numpy."""

import dataclasses

import numpy as np
import pytest

from vsr_tpu import cli as jax_cli
from vsr_tpu import i18n as jax_i18n
from vsr_tpu import native as jax_native
from vsr_tpu.config import Config as JaxConfig
from vsr_tpu.detect import boxes as jax_boxes
from vsr_tpu.detect import postprocess as jax_postprocess
from vsr_tpu.detect import preprocess as jax_preprocess
from vsr_tpu.masks import intervals as jax_intervals
from vsr_tpu.masks import mask as jax_mask
from vsr_tpu.masks import solver as jax_solver
from vsr_tpu.version import __version__ as jax_version
from vsr_tpu_torch import cli, i18n, native
from vsr_tpu_torch.config import Config, InpaintMode
from vsr_tpu_torch.detect import boxes, postprocess, preprocess
from vsr_tpu_torch.masks import intervals, mask, solver
from vsr_tpu_torch.version import __version__

SEEDS = range(4)


def _boxes(rng, h, w, n):
    """n random (xmin, xmax, ymin, ymax) boxes, some poking past the canvas."""
    out = []
    for _ in range(n):
        x0, y0 = int(rng.integers(-20, w)), int(rng.integers(-20, h))
        out.append((x0, x0 + int(rng.integers(0, w // 2)), y0, y0 + int(rng.integers(0, h // 4))))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_create_and_binarize_mask(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(40, 200)), int(rng.integers(40, 300))
    boxes = _boxes(rng, h, w, int(rng.integers(0, 5)))
    dev = int(rng.integers(1, 15))
    got = mask.create_mask((h, w), boxes, dev)
    want = jax_mask.create_mask((h, w), boxes, dev)
    np.testing.assert_array_equal(got, want)
    noisy = rng.integers(0, 256, (h, w), np.uint8)
    np.testing.assert_array_equal(mask.binarize_mask(noisy), jax_mask.binarize_mask(noisy))
    np.testing.assert_array_equal(mask.binarize_mask(got), jax_mask.binarize_mask(got))


@pytest.mark.parametrize("seed", range(8))
def test_inpaint_area_by_mask(seed):
    rng = np.random.default_rng(100 + seed)
    H, W = (720, 1280) if seed % 2 else (1080, 1920)
    m = jax_mask.create_mask((H, W), _boxes(rng, H, W, int(rng.integers(0, 6))), 10)
    bin3 = jax_mask.binarize_mask(m)
    h = int(W * 3 / 16)
    for arr in (m, bin3):
        assert (solver.get_inpaint_area_by_mask(W, H, h, arr)
                == jax_solver.get_inpaint_area_by_mask(W, H, h, arr))


@pytest.mark.parametrize("seed", SEEDS)
def test_ab_sections(seed):
    rng = np.random.default_rng(200 + seed)
    starts = rng.integers(0, 500, 3)
    sections = [range(int(s), int(s + rng.integers(1, 80))) for s in starts]
    for sec in (None, [], sections):
        for frame_no in rng.integers(0, 600, 50):
            assert (intervals.is_frame_number_in_ab_sections(int(frame_no), sec)
                    == jax_intervals.is_frame_number_in_ab_sections(int(frame_no), sec))


def _ranges(rng, n):
    """n (start, end) ranges over frames 1..400, some single-frame, some
    touching or overlapping."""
    starts = np.sort(rng.integers(1, 400, n))
    return [(int(s), int(s + rng.choice([0, 0, 1, 5, 30]))) for s in starts]


def _box_dict(rng, n_frames):
    """{frame: [boxes]} with runs of repeated, jittered and changed boxes."""
    out, boxes = {}, _boxes(rng, 1080, 1920, 2)
    for f in sorted(set(int(x) for x in rng.integers(1, 300, n_frames))):
        r = rng.random()
        if r < 0.2:
            boxes = _boxes(rng, 1080, 1920, int(rng.integers(1, 4)))
        elif r < 0.5:
            boxes = [tuple(int(v + rng.integers(-25, 26)) for v in b) for b in boxes]
        out[f] = list(boxes)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_interval_algebra(seed):
    rng = np.random.default_rng(500 + seed)
    for n in (0, 1, 7, 40):
        ranges = _ranges(rng, n)
        back, fwd = int(rng.integers(0, 12)), int(rng.integers(0, 12))
        assert (intervals.expand_frame_ranges(ranges, back, fwd)
                == jax_intervals.expand_frame_ranges(ranges, back, fwd))
        for target in (1, 4, 10, 25):
            assert (intervals.filter_and_merge_intervals(ranges, target)
                    == jax_intervals.filter_and_merge_intervals(ranges, target))
        data = list(range(int(rng.integers(0, 120))))
        size = int(rng.integers(1, 60))
        assert (list(intervals.batch_generator(data, size))
                == list(jax_intervals.batch_generator(data, size)))
        subs = _box_dict(rng, n * 5)
        for fn in ("find_continuous_ranges", "find_continuous_ranges_with_same_mask"):
            assert getattr(intervals, fn)(subs) == getattr(jax_intervals, fn)(subs)
        tol = (int(rng.integers(0, 30)), int(rng.integers(0, 30)))
        assert intervals.unify_regions(subs, *tol) == jax_intervals.unify_regions(subs, *tol)
        for a, b in zip(_boxes(rng, 1080, 1920, 8), _boxes(rng, 1080, 1920, 8)):
            assert intervals.are_similar(a, b, *tol) == jax_intervals.are_similar(a, b, *tol)


@pytest.mark.parametrize("seed", SEEDS)
def test_detect_preprocess_bit_identical(seed):
    rng = np.random.default_rng(600 + seed)
    h, w = int(rng.integers(24, 1200)), int(rng.integers(24, 2000))
    frame = rng.integers(0, 256, (h, w, 3), np.uint8)
    long_side = int(rng.choice([960, 640, 320]))
    assert preprocess.det_resize_shape(h, w, long_side) == jax_preprocess.det_resize_shape(
        h, w, long_side)
    assert preprocess.scale_factors(h, w, long_side) == jax_preprocess.scale_factors(
        h, w, long_side)
    got = preprocess.preprocess_frame(frame, long_side)
    want = jax_preprocess.preprocess_frame(frame, long_side)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_detect_postprocess_and_boxes_bit_identical(seed):
    """DBPostProcess on a map with text-like bars at several confidences,
    noise and specks, into a destination of another size; then the quads to
    boxes."""
    rng = np.random.default_rng(700 + seed)
    h, w = 32 * int(rng.integers(2, 12)), 32 * int(rng.integers(2, 16))
    prob = rng.random((h, w)).astype(np.float32) * 0.28
    prob[rng.random((h, w)) < 0.002] = 0.9  # specks
    for _ in range(int(rng.integers(2, 10))):
        y, x = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 4))
        bar = (slice(y, y + int(rng.integers(3, 30))), slice(x, x + int(rng.integers(3, 120))))
        prob[bar] = rng.uniform(0.45, 1) - 0.1 * rng.random(prob[bar].shape)
    dest = (int(rng.integers(50, 1100)), int(rng.integers(50, 2000)))
    got = postprocess.db_postprocess(prob, dest)
    want = jax_postprocess.db_postprocess(prob, dest)
    assert len(got) == len(want)
    for g, q in zip(got, want):
        np.testing.assert_array_equal(g, q)
    quads = [q.tolist() for q in want]
    assert boxes.get_coordinates(quads) == jax_boxes.get_coordinates(quads)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_crop_resize_bit_identical(seed):
    rng = np.random.default_rng(300 + seed)
    H, W = int(rng.integers(120, 400)), int(rng.integers(160, 640))
    frame = rng.integers(0, 256, (H, W, 3), np.uint8)
    y0 = int(rng.integers(0, H // 2))
    crop_h = int(rng.integers(8, H - y0))
    got = native.crop_resize(frame, y0, crop_h, 64, 48)
    want = jax_native.crop_resize(frame, y0, crop_h, 64, 48)
    assert want is not None, "the JAX package's native library did not build"
    np.testing.assert_array_equal(got, want)
    out = np.empty((48, 64, 3), np.uint8)
    assert native.crop_resize(frame, y0, crop_h, 64, 48, out=out) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_native_paste_band_blend_bit_identical(seed):
    rng = np.random.default_rng(400 + seed)
    H, W = int(rng.integers(120, 400)), int(rng.integers(160, 640))
    frame = rng.integers(0, 256, (H, W, 3), np.uint8)
    comp = rng.integers(0, 256, (48, 64, 3), np.uint8)
    y0 = int(rng.integers(0, H // 2))
    band_h = int(rng.integers(8, H - y0))
    mask01 = (rng.random((band_h, W)) < 0.5).astype(np.uint8)
    got, want = frame.copy(), frame.copy()
    native.paste_band_blend(got, comp, mask01, y0, band_h, threads=int(rng.integers(1, 4)))
    assert jax_native.paste_band_blend(want, comp, mask01, y0, band_h)
    np.testing.assert_array_equal(got, want)


def test_native_rejects_non_contiguous():
    frame = np.zeros((64, 80, 3), np.uint8)
    with pytest.raises(ValueError, match="contiguous"):
        native.crop_resize(frame[:, ::2], 0, 32, 16, 8)
    with pytest.raises(ValueError, match="contiguous"):
        native.paste_band_blend(frame[:, ::2], np.zeros((8, 16, 3), np.uint8),
                                np.ones((32, 40), np.uint8), 0, 32)


def test_native_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """No cv2 fallback: a g++ failure raises and carries its output."""
    src = tmp_path / "ops.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    return {k: getattr(v, "value", v) for k, v in d.items()}


def test_config_defaults_match():
    assert _as_dict(Config()) == _as_dict(JaxConfig())
    assert Config().get_sttn_max_load_num() == JaxConfig().get_sttn_max_load_num()
    with pytest.raises(ValueError):
        Config(sttn_neighbor_stride=0)


def test_config_json_round_trip(tmp_path):
    """One config/config.json loads the same into both packages."""
    rng = np.random.default_rng(7)
    cfg = Config(inpaint_mode=InpaintMode.STTN_DET, compute_dtype="float32",
                 sttn_max_load_num=int(rng.integers(1, 300)),
                 window_batch=int(rng.integers(0, 8)), use_pallas=False)
    path = str(tmp_path / "config.json")
    cfg.save(path)
    assert _as_dict(Config.load(path)) == _as_dict(cfg)
    assert _as_dict(JaxConfig.load(path)) == _as_dict(cfg)
    JaxConfig(encode_crf=int(rng.integers(0, 51)), interface="ko").save(path)
    assert _as_dict(Config.load(path)) == _as_dict(JaxConfig.load(path))
    assert _as_dict(Config.load(str(tmp_path / "absent.json"))) == _as_dict(Config())


def test_parser_defaults_match():
    got = vars(cli.build_parser().parse_args([]))
    want = vars(jax_cli.build_parser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want
    argv = ["-i", "a.mp4", "-o", "b.mp4", "-c", "1", "2", "3", "4", "-c", "5", "6", "7", "8",
            "--inpaint-mode", "sttn-det", "--models", "m", "--config", "c.json", "--lang", "ko"]
    got = vars(cli.build_parser().parse_args(argv))
    got.pop("device")
    assert got == vars(jax_cli.build_parser().parse_args(argv))
    assert cli.DEFAULT_CONFIG_PATH == jax_cli.DEFAULT_CONFIG_PATH


@pytest.mark.parametrize("locale", jax_i18n.available_locales())
def test_i18n_catalogue_matches(locale):
    assert i18n.available_locales() == jax_i18n.available_locales()
    got, want = i18n.Translator(locale), jax_i18n.Translator(locale)
    assert got._catalog == want._catalog
    assert got.text("Main", "FinishedProcessing", "x") == want.text("Main", "FinishedProcessing", "x")


def test_version_matches():
    assert __version__ == jax_version
