"""The native library's persistent pool (vsr_tpu_torch/native/vsr_host_ops.cpp)
under the calls it serves: many jobs in a row at every width, two Python
threads calling at once, a forked child pasting on a pool of its own, empty
chunks, and the batch ops' argument checks. Every result is held to the
same op run on the calling thread alone."""

import os
import select
import signal
import threading
import time
import warnings

from tests import torch_test_env  # noqa: F401  (caps torch's threads)
import numpy as np
import pytest

from vsr_tpu_torch import native

H, W, Y0, BAND_H = 96, 160, 40, 48
MODEL_H, COMP_W = 24, 64


def _chunk(n, seed):
    """n frames, their composites and a mask: a small sttn-auto band."""
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]
    comps = rng.integers(0, 256, (n, MODEL_H, COMP_W, 3), np.uint8)
    mask01 = (rng.random((BAND_H, W)) < 0.6).astype(np.uint8)
    return frames, comps, mask01


def _pasted(frames, comps, mask01, threads):
    out = [f.copy() for f in frames]
    native.paste_band_blend_batch(out, comps, mask01, Y0, BAND_H, threads=threads)
    return np.stack(out)


def test_many_jobs_in_a_row_at_every_width():
    """300 jobs, batch and per-frame, paste and crop, widths 1-9 in turn:
    each equals the one-worker result."""
    frames, comps, mask01 = _chunk(9, 0)
    want = _pasted(frames, comps, mask01, 1)
    want_crop = np.zeros((9, MODEL_H, COMP_W, 3), np.uint8)
    native.crop_resize_batch(frames, Y0, BAND_H, want_crop, threads=1)
    want_frame = frames[0].copy()
    native.paste_band_blend(want_frame, comps[0], mask01, Y0, BAND_H, threads=1)
    for i in range(300):
        width = 1 + i % 9
        np.testing.assert_array_equal(_pasted(frames, comps, mask01, width), want)
        crop = np.zeros_like(want_crop)
        native.crop_resize_batch(frames, Y0, BAND_H, crop, threads=width)
        np.testing.assert_array_equal(crop, want_crop)
        frame = frames[0].copy()
        native.paste_band_blend(frame, comps[0], mask01, Y0, BAND_H, threads=width)
        np.testing.assert_array_equal(frame, want_frame)


def test_two_threads_call_at_once():
    """Two Python threads (ctypes lets go of the GIL) each run 40 batch
    pastes of their own chunk at full width: the pool serves one job at a
    time and each thread gets its own result."""
    chunks = [_chunk(7, 1), _chunk(7, 2)]
    wants = [_pasted(*c, 1) for c in chunks]
    start = threading.Barrier(2)
    got = [[], []]

    def work(t):
        start.wait()
        for _ in range(40):
            got[t].append(_pasted(*chunks[t], native.DEFAULT_THREADS))

    threads = [threading.Thread(target=work, args=(t,), daemon=True) for t in range(2)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 60
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    assert not any(th.is_alive() for th in threads)
    for t in range(2):
        assert len(got[t]) == 40
        for out in got[t]:
            np.testing.assert_array_equal(out, wants[t])


def test_forked_child_still_pastes():
    """After the parent's pool has run, a forked child (which has none of
    its threads) pastes at full width on a pool of its own and gets the
    parent's bytes."""
    frames, comps, mask01 = _chunk(8, 3)
    want = _pasted(frames, comps, mask01, native.DEFAULT_THREADS)
    read_fd, write_fd = os.pipe()
    with warnings.catch_warnings():  # fork() of a threaded process warns
        warnings.simplefilter("ignore", DeprecationWarning)
        pid = os.fork()
    if pid == 0:
        code = 1
        try:
            out = _pasted(frames, comps, mask01, native.DEFAULT_THREADS)
            frame = frames[0].copy()
            native.paste_band_blend(frame, comps[0], mask01, Y0, BAND_H)
            data = out.tobytes() + frame.tobytes()
            while data:
                data = data[os.write(write_fd, data):]
            code = 0
        finally:
            os._exit(code)
    os.close(write_fd)
    chunks, deadline = [], time.monotonic() + 60
    try:
        while True:
            ready, _, _ = select.select([read_fd], [], [], max(0.0, deadline - time.monotonic()))
            block = os.read(read_fd, 1 << 20) if ready else None
            if not block:
                break
            chunks.append(block)
    finally:
        os.close(read_fd)
    if block is None:  # the child hung: never leave it behind
        os.kill(pid, signal.SIGKILL)
    _, status = os.waitpid(pid, 0)
    assert block is not None, "the forked child did not finish its paste"
    assert os.waitstatus_to_exitcode(status) == 0
    data = b"".join(chunks)
    one = frames[0].copy()
    native.paste_band_blend(one, comps[0], mask01, Y0, BAND_H)
    assert data == want.tobytes() + one.tobytes()


def test_empty_chunk_runs_nothing():
    """N = 0: both batch ops return 0 workers and touch nothing."""
    mask01 = np.ones((BAND_H, W), np.uint8)
    comps = np.zeros((0, MODEL_H, COMP_W, 3), np.uint8)
    assert native.paste_band_blend_batch([], comps, mask01, Y0, BAND_H) == 0
    out = np.zeros((0, MODEL_H, COMP_W, 3), np.uint8)
    assert native.crop_resize_batch([], Y0, BAND_H, out) == 0


def test_workers_taken_are_capped_by_pool_and_chunk():
    """A job takes min(threads, the pool's workers, N) workers; the pool
    holds min(8, cores) of them (DEFAULT_THREADS)."""
    frames, comps, mask01 = _chunk(3, 4)
    for threads in (1, 2, 3, 16):
        k = native.paste_band_blend_batch([f.copy() for f in frames], comps, mask01, Y0,
                                          BAND_H, threads=threads)
        assert k == min(threads, native.DEFAULT_THREADS, 3)


def test_batch_ops_check_their_arguments():
    """The C-contiguous uint8 rule of the per-frame ops, and the shapes
    that the pointers are read with: a fault raises, with no fallback."""
    frames, comps, mask01 = _chunk(2, 5)
    with pytest.raises(ValueError, match="contiguous"):
        native.paste_band_blend_batch([frames[0][:, ::2], frames[1]], comps, mask01, Y0, BAND_H)
    with pytest.raises(ValueError, match="contiguous"):
        native.crop_resize_batch([frames[0], frames[1].astype(np.int16)], Y0, BAND_H,
                                 np.zeros((2, MODEL_H, COMP_W, 3), np.uint8))
    with pytest.raises(ValueError, match="comps"):
        native.paste_band_blend_batch(frames, comps[:1], mask01, Y0, BAND_H)
    with pytest.raises(ValueError, match="frames"):
        native.paste_band_blend_batch(frames, comps, mask01, H - BAND_H + 1, BAND_H)
    with pytest.raises(ValueError, match="do not fit"):
        native.paste_band_blend_batch(frames, comps, mask01, Y0, BAND_H, r0=4, model_h=MODEL_H)
    with pytest.raises(ValueError, match="out"):
        native.crop_resize_batch(frames, Y0, BAND_H, np.zeros((3, MODEL_H, COMP_W, 3), np.uint8))
