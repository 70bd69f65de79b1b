"""ProPainter's band path on the host (vsr_tpu_torch/inpaint/propainter.py
``__call__``: band plans kept by mask, crops through a persistent staging
buffer, one D2H of the returned rows, one native compose of each output
frame) against the same clip composed in plain numpy from ``inpaint()``
of each band's crops, band after band, as the band path did before it was
staged: byte for byte, with the input frames left as they were.

Cases: one band; two overlapping bands (the second band's crops hold the
first band's result); a band that does not start at column 0 (a width
that is not a multiple of 8); clips of 70, 24 and 70 frames through one
inpainter (the staging buffers made, reused for a shorter clip, reused
again, with no rows left over from the clip before); two frames.
"""

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.inpaint import propainter as pp
from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

TINY_GEN = dict(channel=16, hidden=32, depths=2, n_head=2, window_size=(3, 4), pool_size=(2, 2))
TINY_RAFT = dict(hidden=32, context=32, corr_levels=2, corr_radius=2)


@pytest.fixture(scope="module")
def inp():
    """A narrow inpainter on seeded random weights, fp32, one RAFT step."""
    config = Config(compute_dtype="float32", propainter_raft_iters=1)
    return pp.PropainterInpainter(None, config, dict(TINY_GEN), dict(TINY_RAFT), device="cpu")


def _frames(seed, n, h, w):
    return [np.random.default_rng(seed + j).integers(0, 256, (h, w, 3), np.uint8)
            for j in range(n)]


def _bands(mask):
    H, W = mask.shape
    return get_inpaint_area_by_mask(W, H, int(W * 3 / 16), mask[:, :, None], multiple=8)


def plain_call(inp, frames, mask):
    """Each band's crops through ``inpaint()``, pasted into copies of the
    frames with numpy, band after band."""
    out = [f.copy() for f in frames]
    for ymin, ymax, xmin, xmax in _bands(mask):
        comps = inp.inpaint([f[ymin:ymax, xmin:xmax] for f in out], mask[ymin:ymax, xmin:xmax])
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
