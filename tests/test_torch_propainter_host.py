"""ProPainter's host path (vsr_tpu_torch/inpaint/propainter.py: band plans,
crops through a persistent staging buffer, one D2H of the returned rows,
one native compose of each output frame) against the plain route it
replaced (the stacked frames sent in one copy, the rows fetched by a
blocking copy and pasted into copies of the frames with numpy), on the
same four device stages: byte for byte, with the input frames left as they
were.

``__call__`` cases, each band's crops through the plain route band after
band: one band; two overlapping bands (the second band's crops hold the
first band's result); a band that does not start at column 0 (a width
that is not a multiple of 8); clips of 70, 24 and 70 frames through one
inpainter (the staging buffers made, reused for a shorter clip, reused
again, with no rows left over from the clip before); two frames. Then
``inpaint()`` and ``outpaint()``: two calls on a new inpainter reuse the
staging buffers and equal the plain route.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest
import torch

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint import propainter as pp
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

TINY_GEN = dict(channel=16, hidden=32, depths=2, n_head=2, window_size=(3, 4), pool_size=(2, 2))
TINY_RAFT = dict(hidden=32, context=32, corr_levels=2, corr_radius=2)


def _inpainter():
    """A narrow inpainter on seeded random weights, fp32, one RAFT step."""
    config = Config(compute_dtype="float32", propainter_raft_iters=1)
    return pp.PropainterInpainter(None, config, dict(TINY_GEN), dict(TINY_RAFT), device="cpu")


@pytest.fixture(scope="module")
def inp():
    return _inpainter()


def _frames(seed, n, h, w):
    return [np.random.default_rng(seed + j).integers(0, 256, (h, w, 3), np.uint8)
            for j in range(n)]


def _bands(mask):
    H, W = mask.shape
    return get_inpaint_area_by_mask(W, H, int(W * 3 / 16), mask[:, :, None], multiple=8)


@torch.inference_mode()
def plain_route(inp, frames, flow_mask, hole):
    """The frames, [h, w] float32 flow and frame masks -> the frames through
    the four stages by the plain route: np.stack, one pageable copy in, one
    blocking copy out, the returned rows pasted into copies with numpy."""
    rows = inp._mask_rows(hole)
    if rows is None:
        return [f.copy() for f in frames]
    dev = inp.device
    rgb = inp._rgb(torch.from_numpy(np.stack(frames)).to(dev))
    mw = inp._masked_window_set(hole)
    comp = inp._stages(rgb, torch.from_numpy(flow_mask).to(dev), torch.from_numpy(hole).to(dev),
                       rows, None if mw is None else torch.from_numpy(mw).to(dev))
    band = comp.flip(1).permute(0, 2, 3, 1).cpu().numpy()
    out = []
    for j, frame in enumerate(frames):
        f = frame.copy()
        f[rows[0]:rows[1]] = band[j]
        out.append(f)
    return out


def plain_outpaint(inp, frames, scale):
    """``outpaint()``'s canvas and masks (ref extrapolation :80-118) through
    the plain route."""
    n, (h, w) = len(frames), frames[0].shape[:2]
    eh = int(scale[0] * h) - int(scale[0] * h) % 8
    ew = int(scale[1] * w) - int(scale[1] * w) % 8
    y0, x0 = (eh - h) // 2, (ew - w) // 2
    canvas = np.zeros((n, eh, ew, 3), np.uint8)
    canvas[:, y0:y0 + h, x0:x0 + w] = np.stack(frames)
    dil_h, dil_w = (4 if y0 > 10 else 0), (4 if x0 > 10 else 0)
    flow_mask = np.ones((eh, ew), np.float32)
    flow_mask[y0 + dil_h:y0 + h - dil_h, x0 + dil_w:x0 + w - dil_w] = 0
    mask = np.ones((eh, ew), np.float32)
    mask[y0:y0 + h, x0:x0 + w] = 0
    return plain_route(inp, list(canvas), flow_mask, mask)


def plain_call(inp, frames, mask):
    """Each band's crops through the plain route, pasted into copies of the
    frames with numpy, band after band."""
    out = [f.copy() for f in frames]
    for ymin, ymax, xmin, xmax in _bands(mask):
        dilated = pp.dilate_mask(mask[ymin:ymax, xmin:xmax], inp.mask_dilation)
        comps = plain_route(inp, [f[ymin:ymax, xmin:xmax] for f in out], dilated, dilated)
        for f, comp in zip(out, comps):
            f[ymin:ymax, xmin:xmax] = comp
    return out


def _check_call(inp, frames, mask):
    """``inp(frames, mask)`` equals plain_call byte for byte, returns new
    arrays, and leaves the frames as they were; returns the output."""
    before = [f.copy() for f in frames]
    got = inp(frames, mask)
    for f, b in zip(frames, before):
        np.testing.assert_array_equal(f, b)
    want = plain_call(inp, frames, mask)
    assert len(got) == len(frames)
    for g, w, f in zip(got, want, frames):
        assert g is not f and g.flags.c_contiguous and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    return got


def _one_band_mask(h, w):
    mask = np.zeros((h, w), np.uint8)
    mask[h // 2:h // 2 + 8, w // 4:w - 8] = 255
    return mask


@pytest.mark.parametrize("T", [2, 10])
def test_one_band_matches_plain(inp, T):
    mask = _one_band_mask(96, 128)
    assert len(_bands(mask)) == 1
    frames = _frames(10 + T, T, 96, 128)
    got = _check_call(inp, frames, mask)
    ymin = _bands(mask)[0][0]
    assert any((g[ymin:] != f[ymin:]).any() for g, f in zip(got, frames))


def test_overlapping_bands_see_each_other(inp):
    """Two bands that share rows: the second crops the first one's result,
    so its output differs from a second band run on the input frames."""
    mask = np.zeros((96, 128), np.uint8)
    mask[20:30, 10:60] = 255
    mask[42:50, 30:120] = 255
    (a0, a1, _, _), (b0, b1, _, _) = _bands(mask)
    assert a0 < b0 < a1 < b1
    frames = _frames(30, 6, 96, 128)
    got = _check_call(inp, frames, mask)
    second = mask.copy()
    second[:a1] = 0  # the second band alone, over the input frames
    alone = inp(frames, second)
    assert any((g[a1:b1] != s[a1:b1]).any() for g, s in zip(got, alone))


def test_band_off_column_zero(inp):
    """A width of 100 gives a band of columns [2, 98): the crop and the
    compose work on that window, the outer columns stay the input's."""
    mask = _one_band_mask(64, 100)
    (_, _, xmin, xmax), = _bands(mask)
    assert (xmin, xmax) == (2, 98)
    frames = _frames(40, 5, 64, 100)
    got = _check_call(inp, frames, mask)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g[:, :xmin], f[:, :xmin])
        np.testing.assert_array_equal(g[:, xmax:], f[:, xmax:])


def test_clips_of_70_24_70_reuse_the_staging(inp):
    """One inpainter, three clips: the buffers are made for 70 frames and
    kept for 24 and 70; every clip equals its plain composition."""
    mask = _one_band_mask(64, 128)
    buffers = []
    for k, T in enumerate((70, 24, 70)):
        _check_call(inp, _frames(100 * k, T, 64, 128), mask)
        buffers.append((inp._host_in.data_ptr(), inp._host_out.data_ptr()))
    assert buffers[0] == buffers[1] == buffers[2]


@pytest.mark.parametrize("route", ["inpaint", "outpaint"])
def test_inpaint_and_outpaint_reuse_the_staging(route):
    """Two calls at one frame size on a new inpainter: the second reuses
    the staging buffers the first made, and each output equals the plain
    route's byte for byte, with the input frames left as they were."""
    fresh = _inpainter()
    mask = _one_band_mask(64, 128)
    dilated = pp.dilate_mask(mask, fresh.mask_dilation)
    buffers = []
    for k in range(2):
        frames = _frames(200 + 10 * k, 6, 64, 128)
        before = [f.copy() for f in frames]
        if route == "inpaint":
            got = fresh.inpaint(frames, mask)
            want = plain_route(fresh, frames, dilated, dilated)
        else:
            got = fresh.outpaint(frames, (1.25, 1.25))
            want = plain_outpaint(fresh, frames, (1.25, 1.25))
        buffers.append((fresh._host_in.data_ptr(), fresh._host_out.data_ptr()))
        for f, b in zip(frames, before):
            np.testing.assert_array_equal(f, b)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert buffers[0] == buffers[1]
