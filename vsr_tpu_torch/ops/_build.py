"""Build-at-first-use for the port's CUDA kernels.

Every ``vsr_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, written under
``vsr_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with ctypes.
The library is rebuilt when any source is newer than it. A failed build
raises with nvcc's output: there is no fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libvsr_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# nvcc's output of the last build in this process (ptxas register and spill
# counts), empty when the library was up to date.
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def build() -> str:
    """Compile the kernels if the library is missing or stale; returns its path."""
    global build_log
    if not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, LIB_PATH)  # atomic: concurrent builders never see half a file
    build_log = proc.stdout
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("token_attention_f32", "token_attention_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                               i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
                fn.restype = i32
            lib.token_attention_splits.argtypes = [i32, i32, i32, i32]
            lib.token_attention_splits.restype = i32
            _lib = lib
    return _lib
