"""Native host ops: ctypes bindings over vsr_host_ops.cpp (a copy of
``vsr_tpu/native``, so the port pastes bit for bit as the JAX package does).

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
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "vsr_host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libvsr_host_ops.so")
# the JAX package's flags: the same code from the same compiler gives the same bytes
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

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
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check(**arrays: np.ndarray) -> None:
    for name, arr in arrays.items():
        if arr.dtype != np.uint8 or not arr.flags.c_contiguous:
            raise ValueError(f"{name} must be a C-contiguous uint8 array")


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
