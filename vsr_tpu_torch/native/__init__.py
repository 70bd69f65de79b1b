"""Native host ops: ctypes bindings over vsr_host_ops.cpp (the per-pixel
arithmetic of ``vsr_tpu/native``, so the port pastes bit for bit as the JAX
package does).

Parallel work runs on the library's one persistent pool of min(8, cores)
workers (the calling thread among them), made on first use: ``threads``
is the most of them a call may take. The per-frame ops share a frame's rows
among them; the ``*_batch`` ops take a whole chunk in one call and share its
frames, and return how many workers took part. ``crop_batch`` and
``compose_rows_batch`` are ProPainter's band path: a plain crop into a
staging buffer and a one-pass compose of each output frame.

g++ builds the shared library at first use into ``vsr_tpu_torch/build/``
(listed in ``.gitignore``) and rebuilds it when the source is newer. A failed
build raises with the compiler's output, as the CUDA kernels' build does:
there is no cv2 fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "vsr_host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libvsr_host_ops.so")
# the JAX package's flags: the same code from the same compiler gives the same bytes
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# the native pool's size: the most workers any call runs on
DEFAULT_THREADS = min(8, os.cpu_count() or 1)


def build() -> str:
    """Compile the library if it is missing or older than its source."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, LIB_PATH)  # atomic: concurrent builders never see half a file
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded host-op library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32 = ctypes.c_int
            lib.paste_band_blend.argtypes = [u8p, i32, u8p, i32, i32, u8p, i32, i32, i32, i32]
            lib.crop_resize.argtypes = [u8p, i32, i32, i32, i32, u8p, i32, i32, i32]
            ptrs = ctypes.POINTER(ctypes.c_void_p)
            lib.paste_band_blend_batch.argtypes = [
                ptrs, i32, i32, u8p, i32, i32, i32, i32, u8p, i32, i32, i32, i32]
            lib.paste_band_blend_batch.restype = i32
            lib.crop_resize_batch.argtypes = [
                ptrs, i32, i32, i32, i32, i32, u8p, i32, i32, i32]
            lib.crop_resize_batch.restype = i32
            lib.crop_batch.argtypes = [ptrs, i32, i32, i32, i32, i32, i32, u8p, i32]
            lib.crop_batch.restype = i32
            lib.compose_rows_batch.argtypes = [
                ptrs, ptrs, i32, i32, i32, u8p, i32, i32, i32, i32, i32]
            lib.compose_rows_batch.restype = i32
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(**arrays: np.ndarray) -> None:
    for name, arr in arrays.items():
        if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
            raise ValueError(f"{name} must be a C-contiguous uint8 array")


def _frame_ptrs(frames: Sequence[np.ndarray], width: int, rows: int):
    """The frames' data pointers as a C array, after checking that each is a
    C-contiguous uint8 [H, width, 3] image with at least ``rows`` rows."""
    for j, frame in enumerate(frames):
        _check(**{f"frames[{j}]": frame})
        if frame.ndim != 3 or frame.shape[1:] != (width, 3) or frame.shape[0] < rows:
            raise ValueError(f"frames[{j}] is {frame.shape}, expected [>={rows}, {width}, 3]")
    return (ctypes.c_void_p * len(frames))(*[f.ctypes.data for f in frames])


def paste_band_blend(
    frame: np.ndarray,      # [H, W, 3] uint8, modified in place
    comp: np.ndarray,       # [comp_h, comp_w, 3] uint8
    mask01: np.ndarray,     # [band_h, W] uint8 {0,1}
    y0: int,
    band_h: int,
    threads: int = DEFAULT_THREADS,
) -> None:
    """Fused resize + masked blend of comp into frame rows [y0, y0+band_h)."""
    _check(frame=frame, comp=comp, mask01=mask01)
    lib = get_lib()
    W = frame.shape[1]
    lib.paste_band_blend(
        _ptr(frame), W, _ptr(comp), comp.shape[0], comp.shape[1],
        _ptr(mask01), y0, band_h, W, threads)


def crop_resize(
    frame: np.ndarray,  # [H, W, 3] uint8
    y0: int,
    crop_h: int,
    out_w: int,
    out_h: int,
    threads: int = 1,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Bilinear resize of frame[y0:y0+crop_h] to (out_h, out_w). ``out``
    writes into a caller buffer (one row of a preallocated chunk stack)."""
    if out is None:
        out = np.empty((out_h, out_w, 3), np.uint8)
    elif out.shape != (out_h, out_w, 3):
        raise ValueError(f"out is {out.shape}, expected {(out_h, out_w, 3)}")
    _check(frame=frame, out=out)
    lib = get_lib()
    W = frame.shape[1]
    lib.crop_resize(_ptr(frame), W, y0, crop_h, W, _ptr(out), out_h, out_w, threads)
    return out


def paste_band_blend_batch(
    frames: Sequence[np.ndarray],  # N x [H, W, 3] uint8, modified in place
    comps: np.ndarray,             # [N, rows, comp_w, 3] uint8
    mask01: np.ndarray,            # [band_h, W] uint8 {0,1}
    y0: int,
    band_h: int,
    r0: int = 0,
    model_h: Optional[int] = None,
    threads: int = DEFAULT_THREADS,
) -> int:
    """``paste_band_blend`` of ``comps[j]`` into ``frames[j]`` for a whole
    chunk in one call, a frame per worker. ``comps`` holds rows
    [r0, r0 + rows) of composites ``model_h`` rows high (default r0 + rows);
    their other rows read as zeros. Returns the workers that took part."""
    _check(comps=comps, mask01=mask01)
    n = len(frames)
    if comps.ndim != 4 or comps.shape[0] != n or comps.shape[3] != 3:
        raise ValueError(f"comps is {comps.shape}, expected [{n}, rows, w, 3]")
    if mask01.ndim != 2 or mask01.shape[0] != band_h:
        raise ValueError(f"mask01 is {mask01.shape}, expected [{band_h}, W]")
    rows, W = comps.shape[1], mask01.shape[1]
    model_h = r0 + rows if model_h is None else model_h
    if not 0 <= r0 <= r0 + rows <= model_h:
        raise ValueError(f"rows [{r0}, {r0 + rows}) do not fit a {model_h}-row composite")
    ptrs = _frame_ptrs(frames, W, y0 + band_h)
    return get_lib().paste_band_blend_batch(
        ptrs, n, W, _ptr(comps), rows, r0, model_h, comps.shape[2],
        _ptr(mask01), y0, band_h, W, threads)


def crop_resize_batch(
    frames: Sequence[np.ndarray],  # N x [H, W, 3] uint8
    y0: int,
    crop_h: int,
    out: np.ndarray,               # [N, out_h, out_w, 3] uint8
    threads: int = DEFAULT_THREADS,
) -> int:
    """``crop_resize`` of ``frames[j]`` into ``out[j]`` for a whole chunk in
    one call, a frame per worker. Returns the workers that took part."""
    _check(out=out)
    n = len(frames)
    if out.ndim != 4 or out.shape[0] != n or out.shape[3] != 3:
        raise ValueError(f"out is {out.shape}, expected [{n}, out_h, out_w, 3]")
    W = frames[0].shape[1] if n else 0
    ptrs = _frame_ptrs(frames, W, y0 + crop_h)
    return get_lib().crop_resize_batch(
        ptrs, n, W, y0, crop_h, W, _ptr(out), out.shape[1], out.shape[2], threads)


def _window(frames: Sequence[np.ndarray], stack: np.ndarray, name: str,
            y0: int, x0: int) -> int:
    """Checks that ``stack`` ([N, h, w, 3] uint8) is one window of each of
    the N ``frames`` at (y0, x0); returns the frames' width."""
    _check(**{name: stack})
    n = len(frames)
    if stack.ndim != 4 or stack.shape[0] != n or stack.shape[3] != 3:
        raise ValueError(f"{name} is {stack.shape}, expected [{n}, h, w, 3]")
    W = frames[0].shape[1] if n else 0
    h, w = stack.shape[1:3]
    if n and not (0 <= y0 and 0 <= x0 and x0 + w <= W):
        raise ValueError(f"a {h}x{w} window at ({y0}, {x0}) does not fit {W}-wide frames")
    return W


def crop_batch(
    frames: Sequence[np.ndarray],  # N x [H, W, 3] uint8
    y0: int,
    x0: int,
    out: np.ndarray,               # [N, h, w, 3] uint8
    threads: int = DEFAULT_THREADS,
) -> int:
    """``out[j] = frames[j][y0:y0 + h, x0:x0 + w]`` for a whole chunk in one
    call, a frame per worker. Returns the workers that took part."""
    W = _window(frames, out, "out", y0, x0)
    h, w = out.shape[1:3]
    ptrs = _frame_ptrs(frames, W, y0 + h)
    return get_lib().crop_batch(ptrs, len(frames), W, y0, x0, h, w, _ptr(out), threads)


def compose_rows_batch(
    srcs: Sequence[np.ndarray],  # N x [H, W, 3] uint8
    dsts: Sequence[np.ndarray],  # N x [H, W, 3] uint8, written
    rows: np.ndarray,            # [N, h, w, 3] uint8
    y0: int,
    x0: int,
    threads: int = DEFAULT_THREADS,
) -> int:
    """``dsts[j]`` = ``srcs[j]`` with the window ``[y0:y0 + h, x0:x0 + w]``
    from ``rows[j]``, each byte of ``dsts[j]`` written once, for a whole
    chunk in one call, a frame per worker. Where ``dsts[j]`` is
    ``srcs[j]`` only the window is written. Returns the workers that took
    part."""
    W = _window(srcs, rows, "rows", y0, x0)
    if len(dsts) != len(srcs):
        raise ValueError(f"{len(dsts)} destinations for {len(srcs)} frames")
    H = srcs[0].shape[0] if len(srcs) else 0
    for j, (src, dst) in enumerate(zip(srcs, dsts)):
        if src.shape != (H, W, 3) or dst.shape != (H, W, 3):
            raise ValueError(f"frame {j}: {src.shape} into {dst.shape}, expected {(H, W, 3)}")
        if dst.ctypes.data != src.ctypes.data and np.may_share_memory(src, dst):
            raise ValueError(f"frame {j}: the destination overlaps its source")
    src_ptrs = _frame_ptrs(srcs, W, y0 + rows.shape[1])
    dst_ptrs = _frame_ptrs(dsts, W, H)
    return get_lib().compose_rows_batch(src_ptrs, dst_ptrs, len(srcs), H, W, _ptr(rows),
                                        y0, x0, rows.shape[1], rows.shape[2], threads)
