"""The port's own copies of the JAX package's host modules (config, masks,
interval algebra, detection pre- and post-processing, native host ops,
i18n, cli parser), held against ``vsr_tpu``'s on the same inputs, made from
a seed with numpy."""

import dataclasses
import importlib

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
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
from vsr_tpu_torch.inpaint import paste
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


@pytest.mark.parametrize("seed", range(6))
def test_inpaint_area_by_mask_multiple(seed):
    """ProPainter's bands, rounded to a multiple of 8 (and of 16)."""
    rng = np.random.default_rng(150 + seed)
    H, W = ((720, 1280), (1080, 1920), (101, 203))[seed % 3]
    m = jax_mask.create_mask((H, W), _boxes(rng, H, W, int(rng.integers(1, 6))), 10)
    h = int(W * 3 / 16)
    for multiple in (8, 16):
        got = solver.get_inpaint_area_by_mask(W, H, h, m, multiple=multiple)
        assert got == jax_solver.get_inpaint_area_by_mask(W, H, h, m, multiple=multiple)
        for ymin, ymax, xmin, xmax in got:
            assert (ymax - ymin) % multiple == 0 and (xmax - xmin) % multiple == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_split_range_by_scene(seed):
    rng = np.random.default_rng(700 + seed)
    for n in (0, 1, 7, 40):
        ranges = intervals.find_continuous_ranges_with_same_mask(_box_dict(rng, n * 5))
        points = [int(p) for p in rng.integers(1, 300, int(rng.integers(0, 12)))]
        assert (intervals.split_range_by_scene(ranges, points)
                == jax_intervals.split_range_by_scene(ranges, points))


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_scores_bit_identical(seed):
    """frame_scores on random HSV stacks, the downscale factor, and the
    detector's defaults."""
    from vsr_tpu.scenes import content as jax_content
    from vsr_tpu_torch.scenes import content

    rng = np.random.default_rng(800 + seed)
    hsv = rng.integers(0, 256, (int(rng.integers(2, 9)), 24, 40, 3), np.uint8)
    weights = tuple(float(w) for w in rng.uniform(0, 2, 3))
    np.testing.assert_array_equal(content.frame_scores(hsv, weights),
                                  jax_content.frame_scores(hsv, weights))
    for width in (100, 255, 256, 640, 1920):
        assert (content.compute_downscale_factor(width)
                == jax_content.compute_downscale_factor(width))
    assert (dataclasses.asdict(content.ContentDetectorParams())
            == dataclasses.asdict(jax_content.ContentDetectorParams()))


@pytest.mark.parametrize("threshold", [12.0, 27.0])
def test_scene_cuts_bit_identical(threshold, tmp_path):
    """detect_scene_cuts / get_scene_div_frame_no on a 90-frame mp4 with
    three hard cuts and a slow fade."""
    import cv2

    from vsr_tpu.scenes import content as jax_content
    from vsr_tpu_torch.scenes import content

    path = str(tmp_path / "cuts.mp4")
    rng = np.random.default_rng(9)
    colours = rng.integers(0, 256, (4, 3))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (320, 96))
    for i in range(90):
        frame = np.full((96, 320, 3), colours[min(i // 20, 3)], np.uint8)
        frame[:, : 3 * i % 320] //= 2 if i % 7 else 1
        writer.write(frame)
    writer.release()
    params = (content.ContentDetectorParams(threshold=threshold),
              jax_content.ContentDetectorParams(threshold=threshold))
    got = content.detect_scene_cuts(path, params[0], batch=16)
    assert got == jax_content.detect_scene_cuts(path, params[1], batch=16)
    assert len(got) >= 3
    assert (content.get_scene_div_frame_no(path, params[0])
            == jax_content.get_scene_div_frame_no(path, params[1]))


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


# The batched ops against the per-frame port ops and the JAX package's, for
# every worker count: random shapes; composite slices [r0, r1) whose rows
# outside fall under the mask (they read as zeros, as paste_band's
# full-height buffer holds them); and the benchmark cell's geometry (1080p,
# a 360-row band at y0 720, the 1364x140 mask at band rows 220-360, a
# 640x120 model band and its out_rows slice).
BATCH_NS = (1, 7, 50)
WORKERS = range(1, 9)


def _assert_same(got, want):
    """Byte equality; numpy's report (slow on whole frames) only on failure."""
    if got.shape != want.shape or not np.array_equal(got, want):
        np.testing.assert_array_equal(got, want)


def _rolled(base, n):
    """n distinct frames from one (cheap to make again for the reference)."""
    return [np.roll(base, 7 * j, axis=1) for j in range(n)]


def _paste_geometry(case):
    """(frame base, y0, band_h, mask [band_h, W], model_h, r0, r1, comp_w)."""
    if case == "band_1080p":
        H, W, y0, band_h, model_h, comp_w = 1080, 1920, 720, 360, 120, 640
        full = np.zeros((H, W, 3), np.uint8)
        full[y0 + 220 : y0 + 360, 278:1642] = 1
        r0, r1 = paste.band_out_rows(full, (y0, H, 0, W), model_h)
        assert 0 < r0 < r1 <= model_h
        mask01 = np.ascontiguousarray(full[y0:H, :, 0])
        rng = np.random.default_rng(500)
        return rng.integers(0, 256, (H, W, 3), np.uint8), y0, band_h, mask01, model_h, r0, r1, comp_w
    kind, seed = case.split("-")
    rng = np.random.default_rng(510 + int(seed))
    H, W = int(rng.integers(120, 300)), int(rng.integers(160, 480))
    y0 = int(rng.integers(0, H // 2))
    band_h = int(rng.integers(8, H - y0))
    model_h, comp_w = int(rng.integers(6, 60)), int(rng.integers(8, 90))
    mask01 = (rng.random((band_h, W)) < 0.5).astype(np.uint8)
    if kind == "slice":  # a middle slice: the mask reaches past its support
        r0 = int(rng.integers(1, model_h // 2))
        r1 = int(rng.integers(r0 + 1, model_h))
    else:
        r0, r1 = 0, model_h
    return rng.integers(0, 256, (H, W, 3), np.uint8), y0, band_h, mask01, model_h, r0, r1, comp_w


@pytest.mark.parametrize("n", BATCH_NS)
@pytest.mark.parametrize("case", ["random-0", "random-1", "slice-0", "slice-1", "band_1080p"])
def test_native_paste_band_blend_batch_bit_identical(case, n):
    """paste_band_blend_batch at 1-8 workers equals, byte for byte, the
    per-frame port op and the JAX package's on the zero-filled full-height
    composite; the frames' other rows stay as they were."""
    base, y0, band_h, mask01, model_h, r0, r1, comp_w = _paste_geometry(case)
    comps = np.random.default_rng(520 + n).integers(0, 256, (n, r1 - r0, comp_w, 3), np.uint8)
    want = []  # the band rows of each frame after a per-frame paste
    for j, frame in enumerate(_rolled(base, n)):
        full = np.zeros((model_h, comp_w, 3), np.uint8)
        full[r0:r1] = comps[j]
        got, jax_got = frame.copy(), frame.copy()
        native.paste_band_blend(got, full, mask01, y0, band_h)
        assert jax_native.paste_band_blend(jax_got, full, mask01, y0, band_h)
        _assert_same(got, jax_got)
        want.append(got[y0 : y0 + band_h].copy())
    frames = [f.copy() for f in _rolled(base, n)]
    for workers in WORKERS:
        for frame, band in zip(frames, _rolled(base[y0 : y0 + band_h], n)):
            frame[y0 : y0 + band_h] = band
        k = native.paste_band_blend_batch(frames, comps, mask01, y0, band_h, r0, model_h,
                                          threads=workers)
        assert k == min(workers, native.DEFAULT_THREADS, n)
        for frame, band in zip(frames, want):
            _assert_same(frame[y0 : y0 + band_h], band)
    for frame, original in zip(frames, _rolled(base, n)):
        _assert_same(frame[:y0], original[:y0])
        _assert_same(frame[y0 + band_h :], original[y0 + band_h :])


@pytest.mark.parametrize("n", BATCH_NS)
@pytest.mark.parametrize("case", ["random-0", "random-1", "band_1080p"])
def test_native_crop_resize_batch_bit_identical(case, n):
    """crop_resize_batch at 1-8 workers equals, byte for byte, the
    per-frame port op and the JAX package's."""
    if case == "band_1080p":
        rng = np.random.default_rng(530)
        base, y0, crop_h, out_w, out_h = (rng.integers(0, 256, (1080, 1920, 3), np.uint8),
                                          720, 360, 640, 120)
    else:
        rng = np.random.default_rng(540 + int(case[-1]))
        H, W = int(rng.integers(120, 300)), int(rng.integers(160, 480))
        base = rng.integers(0, 256, (H, W, 3), np.uint8)
        y0 = int(rng.integers(0, H // 2))
        crop_h = int(rng.integers(8, H - y0))
        out_w, out_h = int(rng.integers(8, 200)), int(rng.integers(6, 80))
    frames = [np.ascontiguousarray(f) for f in _rolled(base, n)]
    want = np.stack([native.crop_resize(f, y0, crop_h, out_w, out_h) for f in frames])
    for j, f in enumerate(frames):
        _assert_same(want[j], jax_native.crop_resize(f, y0, crop_h, out_w, out_h))
    for workers in WORKERS:
        out = np.zeros((n, out_h, out_w, 3), np.uint8)
        assert native.crop_resize_batch(frames, y0, crop_h, out, threads=workers) == min(
            workers, native.DEFAULT_THREADS, n)
        _assert_same(out, want)


def _window_geometry(case):
    """(H, W, y0, x0, h, w) of a window in odd-sized frames: a random one,
    one on the top rows, one on the bottom rows, the whole frame (rows 0
    to H) and one of no rows."""
    rng = np.random.default_rng(560 + len(case))
    H, W = 2 * int(rng.integers(20, 60)) + 1, 2 * int(rng.integers(30, 90)) + 1
    x0 = 2 * int(rng.integers(0, 10)) + 1
    w = 2 * int(rng.integers(1, (W - x0) // 2)) + 1
    h = int(rng.integers(1, H))
    return {"random": (H, W, int(rng.integers(1, H - h)), x0, h, w),
            "top": (H, W, 0, x0, h, w),
            "bottom": (H, W, H - h, x0, h, w),
            "whole": (H, W, 0, 0, H, W),
            "no_rows": (H, W, int(rng.integers(0, H)), x0, 0, w)}[case]


@pytest.mark.parametrize("n", BATCH_NS)
@pytest.mark.parametrize("case", ["random", "top", "bottom", "whole", "no_rows"])
def test_native_crop_and_compose_batch(case, n):
    """crop_batch and compose_rows_batch at 1-8 workers against numpy
    slicing: the crop of a window, and each frame with that window taken
    from the rows (into new frames, and in place); the sources stay as
    they were."""
    H, W, y0, x0, h, w = _window_geometry(case)
    rng = np.random.default_rng(570 + n)
    frames = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]
    rows = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    before = [f.copy() for f in frames]
    want = []
    for f, r in zip(frames, rows):
        g = f.copy()
        g[y0:y0 + h, x0:x0 + w] = r
        want.append(g)
    for workers in WORKERS:
        took = min(workers, native.DEFAULT_THREADS, n)
        crops = np.zeros((n, h, w, 3), np.uint8)
        assert native.crop_batch(frames, y0, x0, crops, threads=workers) == took
        _assert_same(crops, np.stack([f[y0:y0 + h, x0:x0 + w] for f in frames]))
        out = [np.full_like(f, 7) for f in frames]
        assert native.compose_rows_batch(frames, out, rows, y0, x0, threads=workers) == took
        _assert_same(np.stack(out), np.stack(want))
        _assert_same(np.stack(frames), np.stack(before))
        same = [f.copy() for f in frames]
        assert native.compose_rows_batch(same, same, rows, y0, x0, threads=workers) == took
        _assert_same(np.stack(same), np.stack(want))


def test_native_crop_and_compose_check_their_arguments():
    """A window that leaves the frames, a stack of the wrong length, a
    destination of another shape or one that overlaps its source raise."""
    frames = [np.zeros((20, 30, 3), np.uint8) for _ in range(2)]
    rows = np.zeros((2, 4, 10, 3), np.uint8)
    dsts = [np.zeros((20, 30, 3), np.uint8) for _ in range(2)]
    with pytest.raises(ValueError, match="does not fit"):
        native.crop_batch(frames, 0, 25, rows.copy())
    with pytest.raises(ValueError, match="frames"):
        native.crop_batch(frames, 17, 0, rows.copy())
    with pytest.raises(ValueError, match="rows"):
        native.compose_rows_batch(frames, dsts, rows[:1], 0, 0)
    with pytest.raises(ValueError, match="destinations"):
        native.compose_rows_batch(frames, dsts[:1], rows, 0, 0)
    with pytest.raises(ValueError, match="expected"):
        native.compose_rows_batch(frames, [dsts[0], dsts[1][:10]], rows, 0, 0)
    with pytest.raises(ValueError, match="overlaps"):
        native.compose_rows_batch(frames, [frames[0][::-1], dsts[1]], rows, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        native.compose_rows_batch(frames, [dsts[0], dsts[1].astype(np.int16)], rows, 0, 0)


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


@pytest.mark.parametrize("module,name", [("version", "REFERENCE_VERSION"),
                                         ("pipeline", "IMAGE_EXTENSIONS"),
                                         ("detect.backbones", "HGNETV2_B4_OUT_CHANNELS")])
def test_public_constants_match(module, name):
    port = importlib.import_module(f"vsr_tpu_torch.{module}")
    assert getattr(port, name) == getattr(importlib.import_module(f"vsr_tpu.{module}"), name)


@pytest.mark.parametrize("scale", [0.5, 0.75, 1.0])
def test_lcnetv3_det_out_channels_match(scale):
    from vsr_tpu.detect.backbones import lcnetv3_det_out_channels as jax_out_channels
    from vsr_tpu_torch.detect.backbones import lcnetv3_det_out_channels

    assert lcnetv3_det_out_channels(scale) == jax_out_channels(scale)


@pytest.mark.parametrize("seed", SEEDS)
def test_detector_static_helpers_match(seed):
    """SubtitleDetector's passthroughs to the interval helpers, as vsr_tpu's."""
    from vsr_tpu.detect.detector import SubtitleDetector as JaxDetector
    from vsr_tpu_torch.detect.detector import SubtitleDetector

    rng = np.random.default_rng(seed)
    boxes = {int(f): [(1, 5, 2, 4)] if rng.random() < 0.5 else [(0, 3, 0, 3)]
             for f in sorted(rng.choice(60, 30, replace=False))}
    ranges = SubtitleDetector.find_continuous_ranges(boxes)
    assert ranges == JaxDetector.find_continuous_ranges(boxes)
    assert (SubtitleDetector.find_continuous_ranges_with_same_mask(boxes)
            == JaxDetector.find_continuous_ranges_with_same_mask(boxes))
    cuts = sorted(int(c) for c in rng.choice(60, 4, replace=False))
    assert (SubtitleDetector.split_range_by_scene(ranges, cuts)
            == JaxDetector.split_range_by_scene(ranges, cuts))


def _fade_frames(rng, t=90, h=24, w=32):
    """Random piecewise-constant brightness with cuts, drifts and fades."""
    frames, level = [], 120.0
    for _ in range(t):
        r = rng.random()
        if r < 0.08:
            level = rng.uniform(0, 255)
        elif r < 0.25:
            level = float(np.clip(level + rng.uniform(-40, 40), 0, 255))
        noise = rng.normal(0, 2, (h, w, 3))
        frames.append(np.clip(level + noise, 0, 255).astype(np.uint8))
    return frames


@pytest.mark.parametrize("seed", SEEDS)
def test_scene_detectors_bit_identical(seed, tmp_path):
    """AdaptiveDetector and ThresholdDetector (both fade methods, bias,
    final scene) fed the same seeded scores and frames: the same cuts and
    the same StatsManager contents; the stats CSV written by the port loads
    in vsr_tpu to the same rows, and the other way round."""
    from vsr_tpu.scenes import detectors as jax_det
    from vsr_tpu_torch.scenes import detectors as det

    rng = np.random.default_rng(900 + seed)
    frames = _fade_frames(rng)
    scores = rng.gamma(1.5, 6.0, len(frames))
    scores[rng.integers(0, len(frames), 6)] *= 8
    scores[rng.integers(0, len(frames), 3)] = 0.0
    kw = dict(adaptive_threshold=float(rng.uniform(1.5, 4)), min_scene_len=int(rng.integers(1, 12)),
              window_width=int(rng.integers(1, 4)), min_content_val=float(rng.uniform(5, 20)))
    fade = dict(threshold=float(rng.uniform(20, 200)), min_scene_len=int(rng.integers(1, 12)),
                fade_bias=float(rng.uniform(-1, 1)), add_final_scene=bool(seed % 2))
    runs = []
    for mod in (det, jax_det):
        stats = mod.StatsManager()
        adaptive = mod.AdaptiveDetector(stats_manager=stats, **kw)
        cuts = [c for i, s in enumerate(scores) for c in adaptive.process_score(i, float(s))]
        for method in mod.FadeMethod:
            thresh = mod.ThresholdDetector(method=method, stats_manager=stats, **fade)
            cuts.append([c for i, f in enumerate(frames) for c in thresh.process_frame(i, f)]
                        + thresh.post_process(len(frames) - 1))
        assert mod.compute_frame_average(frames[3]) == jax_det.compute_frame_average(frames[3])
        runs.append((cuts, stats._metrics, stats.keys()))
    assert runs[0] == runs[1]
    assert [m.name for m in det.FadeMethod] == [m.name for m in jax_det.FadeMethod]
    mine, theirs = str(tmp_path / "mine.csv"), str(tmp_path / "theirs.csv")
    stats.save_to_csv(theirs)
    port_stats = det.StatsManager()
    port_stats._metrics = runs[0][1]
    port_stats.save_to_csv(mine)
    with open(mine) as a, open(theirs) as b:
        assert a.read() == b.read()
    back, jax_back = det.StatsManager(), jax_det.StatsManager()
    assert back.load_from_csv(theirs) == jax_back.load_from_csv(mine) == len(frames)
    assert back._metrics == jax_back._metrics
    assert back.metrics_exist(5, ["content_val"]) and not back.metrics_exist(5, ["x"])
    assert back.get_metrics(5, ["content_val", "x"]) == jax_back.get_metrics(5, ["content_val", "x"])


def test_scene_detectors_on_video_bit_identical(tmp_path):
    """detect_scene_cuts_adaptive and detect_scene_cuts_threshold on a small
    mp4 with hard cuts and a fade to black."""
    import cv2

    from vsr_tpu.scenes import detectors as jax_det
    from vsr_tpu_torch import scenes
    from vsr_tpu_torch.scenes import detectors as det

    path = str(tmp_path / "scenes.mp4")
    rng = np.random.default_rng(11)
    colours = rng.integers(30, 256, (5, 3))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (320, 96))
    for i in range(100):
        frame = np.full((96, 320, 3), colours[min(i // 20, 4)], np.uint8)
        frame[:, : 3 * i % 320] //= 2 if i % 7 else 1
        if 45 <= i < 55:
            frame[:] = 2  # fade to black and back
        writer.write(frame)
    writer.release()
    got = det.detect_scene_cuts_adaptive(path, det.AdaptiveDetector(min_scene_len=5), batch=16)
    assert got == jax_det.detect_scene_cuts_adaptive(
        path, jax_det.AdaptiveDetector(min_scene_len=5), batch=16)
    assert len(got) >= 3
    cuts = det.detect_scene_cuts_threshold(path, det.ThresholdDetector(min_scene_len=5))
    assert cuts == jax_det.detect_scene_cuts_threshold(path, jax_det.ThresholdDetector(min_scene_len=5))
    assert len(cuts) == 1
    from vsr_tpu import scenes as jax_scenes

    assert scenes.__all__ == jax_scenes.__all__
    assert all(getattr(scenes, name) is not None for name in scenes.__all__)


@pytest.mark.parametrize("path", ["x.PNG", "x.png", "a.mkv", "a.txt", "dir.d/b.JPEG", "noext",
                                  "c.Mp4", "d.webp", "e.ts"])
def test_common_file_type_checks(path):
    from vsr_tpu.utils import common as jax_common
    from vsr_tpu_torch.utils import common

    for name in ("is_image_file", "is_video_file", "is_video_or_image"):
        assert getattr(common, name)(path) == getattr(jax_common, name)(path), name


def test_common_image_io_and_side_by_side(tmp_path):
    """Unicode-safe image read/write and the side-by-side merge write the
    same bytes and frames as vsr_tpu.utils.common, as tests/test_aux.py
    exercises it."""
    import cv2

    from vsr_tpu.utils import common as jax_common
    from vsr_tpu_torch.utils import common

    img = np.random.default_rng(5).integers(0, 256, (20, 30, 3), np.uint8)
    paths = [str(tmp_path / "图片_тест.png"), str(tmp_path / "jax_图片.png")]
    assert common.write_image(paths[0], img) and jax_common.write_image(paths[1], img)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(common.read_image(paths[1]), img)
    np.testing.assert_array_equal(common.read_image(paths[0]), jax_common.read_image(paths[0]))
    assert common.read_image(str(tmp_path / "missing.png")) is None

    def mk(path, level, size):
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, size)
        for i in range(6 if level < 100 else 8):
            w.write(np.full((size[1], size[0], 3), (level + 3 * i) % 256, np.uint8))
        w.release()

    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    mk(a, 50, (64, 48))
    mk(b, 200, (80, 40))  # other size: resized to the left's
    outs = [str(tmp_path / "sbs.mp4"), str(tmp_path / "sbs_jax.mp4")]
    assert common.merge_videos_side_by_side(a, b, outs[0]) == 6
    assert jax_common.merge_videos_side_by_side(a, b, outs[1]) == 6
    caps = [cv2.VideoCapture(p) for p in outs]
    try:
        for _ in range(6):
            (ok0, f0), (ok1, f1) = (c.read() for c in caps)
            assert ok0 and ok1 and f0.shape == (48, 128, 3)
            np.testing.assert_array_equal(f0, f1)
    finally:
        for c in caps:
            c.release()


# ---- training host modules: dataset, Canny targets, scalars, metrics ----


@pytest.mark.parametrize("seed", range(6))
def test_training_masks_bit_identical(seed):
    """random_shape_mask and create_random_moving_masks draw the same masks
    from the same generator state (static and moving both occur)."""
    from vsr_tpu.train import dataset as jax_dataset
    from vsr_tpu_torch.train import dataset

    h, w = (120, 216) if seed % 2 else (60, 108)
    got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    got, want = dataset.random_shape_mask(got_rng, h, w), jax_dataset.random_shape_mask(want_rng, h, w)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    got = dataset.create_random_moving_masks(got_rng, 5, h, w)
    want = jax_dataset.create_random_moving_masks(want_rng, 5, h, w)
    np.testing.assert_array_equal(got, want)
    assert got_rng.random() == want_rng.random()


@pytest.mark.parametrize("as_zip", [True, False])
def test_frame_sequence_dataset_bit_identical(tmp_path, as_zip):
    """Batches from zip archives and frame directories (a short video
    padded too), same seed: the same frames and masks."""
    import os
    import zipfile

    import cv2

    from vsr_tpu.train.dataset import FrameSequenceDataset as JaxDataset
    from vsr_tpu_torch.train.dataset import FrameSequenceDataset

    rng = np.random.default_rng(3)
    root = tmp_path / "videos"
    root.mkdir()
    for v, n in enumerate((8, 3)):
        frames = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(n)]
        if as_zip:
            with zipfile.ZipFile(root / f"vid{v}.zip", "w") as zf:
                for i, f in enumerate(frames):
                    zf.writestr(f"{i:05d}.jpg", cv2.imencode(".jpg", f)[1].tobytes())
        else:
            os.makedirs(root / f"vid{v}")
            for i, f in enumerate(frames):
                cv2.imwrite(str(root / f"vid{v}" / f"{i:05d}.png"), f)
    kw = dict(frame_w=40, frame_h=24, sample_length=4, seed=7)
    got, want = FrameSequenceDataset(str(root), **kw), JaxDataset(str(root), **kw)
    assert len(got) == len(want) == 2
    for (gf, gm), (wf, wm) in zip(
            (next(got.batches(3)) for _ in range(3)), (next(want.batches(3)) for _ in range(3))):
        assert gf.shape == (3, 4, 24, 40, 3) and gm.shape == (3, 4, 24, 40, 1)
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gm, wm)
    with pytest.raises(FileNotFoundError):
        FrameSequenceDataset(str(tmp_path / "none"))


@pytest.mark.parametrize("seed", range(3))
def test_flow_canny_targets_bit_identical(seed):
    """flow_edges_host (global max normalisation, Canny with hysteresis) and
    canny_host without hysteresis, on smooth flows with structure."""
    import torch

    from vsr_tpu.train import canny as jax_canny
    from vsr_tpu_torch.train import canny

    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.normal(0, 4, (6, 1, 12, 14)).astype(np.float32))
    flows = torch.nn.functional.interpolate(base, size=(48, 56), mode="bilinear",
                                            align_corners=False)
    flows = np.moveaxis(flows.reshape(1, 3, 2, 48, 56).numpy(), 2, -1)
    got, want = canny.flow_edges_host(flows), jax_canny.flow_edges_host(flows)
    assert got.shape == (1, 3, 48, 56, 1) and want.sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(canny.flow_edges_host(flows * 0.01),
                                  jax_canny.flow_edges_host(flows * 0.01))  # max < 1: no edges
    img = np.sqrt((flows[0, 0] ** 2).sum(-1)) / 10
    for a, b in zip(canny.canny_host(img, hysteresis=False),
                    jax_canny.canny_host(img, hysteresis=False)):
        np.testing.assert_array_equal(a, b)


def test_scalar_writer_lines_match(tmp_path, monkeypatch):
    """The JSONL lines (all but the wall time) of both writers; their
    tensorboard mirrors are left out (the import loads tensorflow, ~15 s)."""
    import json

    from vsr_tpu.train import scalars as jax_scalars
    from vsr_tpu.train.scalars import ScalarWriter as JaxWriter
    from vsr_tpu_torch.train import scalars
    from vsr_tpu_torch.train.scalars import ScalarWriter

    for module in (scalars, jax_scalars):
        monkeypatch.setattr(module, "_tb_writer", lambda log_dir: None)

    lines = []
    for writer, d in ((ScalarWriter, tmp_path / "port"), (JaxWriter, tmp_path / "jax")):
        with writer(str(d), interval=100) as w:
            w.add("loss/gen", 1.5, step=100)
            w.add("loss/gen", 9.9, step=101)  # off the interval: dropped
            w.add_dict({"dis": 0.25, "gen": np.float32(2.0)}, step=200)
        lines.append([{k: v for k, v in json.loads(line).items() if k != "t"}
                      for line in open(d / "scalars.jsonl")])
    assert lines[0] == lines[1] and len(lines[0]) == 3


@pytest.mark.parametrize("seed", range(3))
def test_metrics_bit_identical(seed):
    """PSNR, SSIM (window shrinking on small images), flow EPE, the Frechet
    distance and VFID over a stand-in feature callable."""
    from vsr_tpu.utils import metrics as jax_metrics
    from vsr_tpu_torch.utils import metrics

    rng = np.random.default_rng(seed)
    h, w = (80, 96) if seed else (40, 50)
    a = rng.integers(0, 256, (h, w, 3), np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0, 255).astype(np.uint8)
    assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == jax_metrics.psnr(a, a) == float("inf")
    assert metrics.ssim(a, b) == jax_metrics.ssim(a, b)
    assert metrics.ssim(a[..., 0], b[..., 0], win_size=7) == jax_metrics.ssim(
        a[..., 0], b[..., 0], win_size=7)
    assert metrics.psnr_and_ssim(a, b) == jax_metrics.psnr_and_ssim(a, b)
    f1, f2 = rng.normal(0, 2, (2, 4, 6, 7, 2))
    assert metrics.flow_epe(f1, f2) == jax_metrics.flow_epe(f1, f2)
    real, fake = rng.normal(0, 1, (60, 8)), rng.normal(0.5, 1.2, (60, 8))
    assert metrics.frechet_distance(real, fake) == jax_metrics.frechet_distance(real, fake)
    videos = rng.uniform(-1, 1, (2, 5, 40, 4, 4, 3))
    proj = rng.normal(0, 1, (48, 8))

    def features(v):  # stand-in for I3D's [N, D] features
        return v.reshape(-1, 48) @ proj

    assert metrics.vfid(*videos, features) == jax_metrics.vfid(*videos, features)
