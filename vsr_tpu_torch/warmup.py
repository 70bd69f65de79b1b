"""Warm-up: build the port's native libraries and run each mode once.

``python -m vsr_tpu_torch --warmup [MODE ...]`` is the port's counterpart of
``vsr_tpu --warmup`` (``vsr_tpu/warmup.py``), which fills the JAX package's
on-disk executable cache. The port has no executable cache: PyTorch runs
eagerly and nothing of a compiled program is kept on disk. A warm-up does two
things:

(a) on a CUDA device, it builds the two native libraries into
    ``vsr_tpu_torch/build/``: the CUDA kernels (nvcc, ``csrc/*.cu``, through
    ``ops/_build.py``) and the host ops (g++, ``native/``). These persist:
    every later process loads them as they are, and rebuilds one only when
    a source is newer. Each build's seconds are logged; a library that is
    up to date logs 0.
(b) it runs each requested mode once on the device at each size, through
    the calls ``vsr_tpu/warmup.py`` makes: the window engine of sttn-auto
    and sttn-det, LaMa's picture and band paths, and (opt-in) ProPainter.
    That proves the weights, the kernels and the device work together, and
    it leaves warm what lives in this process only: the CUDA context,
    cuDNN's and cuBLAS's handles and their algorithm choices (autotuned
    when ``torch.backends.cudnn.benchmark`` is on), cuFFT's plan cache and
    the caching allocator's pool. None of these outlives the process, so a
    separate ``--warmup`` run does not speed up the next process's first
    chunk; a caller who wants that calls ``warmup(...)`` in its own
    process before it works.

A failed build raises with the compiler's output; a missing GPU raises
through ``resolve_device``.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vsr_tpu_torch.config import Config
from vsr_tpu_torch.utils.device import resolve_device

# common source material: 480p (the reference test assets), 720p, 1080p
DEFAULT_SIZES: Tuple[Tuple[int, int], ...] = ((480, 852), (720, 1280),
                                              (1080, 1920))
DEFAULT_MODES: Tuple[str, ...] = ("sttn-auto", "sttn-det", "lama")


def _log(msg: str) -> None:
    print(f"[warmup] {msg}", flush=True)


def _ckpt(checkpoint_dir: Optional[str], name: str) -> Optional[str]:
    if not checkpoint_dir:
        return None
    path = os.path.join(checkpoint_dir, name)
    return path if os.path.exists(path) else None


def build_native() -> None:
    """Build (or find up to date) the CUDA kernels and the host ops, logging
    the seconds each took."""
    from vsr_tpu_torch import native
    from vsr_tpu_torch.ops import _build

    for name, build in (("cuda kernels (nvcc)", _build.build),
                        ("host ops (g++)", native.build)):
        t0 = time.perf_counter()
        build()
        _log(f"build {name}: {time.perf_counter() - t0:.3f}s")


def _warm_sttn(mode: str, cfg: Config, checkpoint_dir: Optional[str],
               clip_len: Optional[int], device: torch.device) -> None:
    if mode == "sttn-auto":
        from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter

        inp = STTNAutoInpainter(checkpoint_path=_ckpt(checkpoint_dir, "sttn_auto.npz"),
                                config=cfg, device=device)
        clip = clip_len or inp.clip_gap
        engine = inp._engine(clip, None)
        frames = np.zeros((clip, inp.model_input_height,
                           inp.model_input_width, 3), np.uint8)
        engine.fetch(engine.dispatch(frames))
    else:
        from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter

        inp = STTNDetInpainter(checkpoint_path=_ckpt(checkpoint_dir, "sttn_det.npz"),
                               config=cfg, device=device)
        clip = clip_len or cfg.get_sttn_max_load_num()
        engine = inp._engine(clip, None)
        frames = np.zeros((clip, inp.model_input_height,
                           inp.model_input_width, 3), np.uint8)
        masks = np.zeros((clip, inp.model_input_height,
                          inp.model_input_width), np.float32)
        masks[:, 2:6, 2:6] = 1.0
        engine.fetch(engine.dispatch(frames, masks))


def _warm_lama(cfg: Config, checkpoint_dir: Optional[str],
               sizes: Sequence[Tuple[int, int]], device: torch.device) -> None:
    from vsr_tpu_torch.inpaint.lama import BAND_BATCH, LamaInpainter

    inp = LamaInpainter(checkpoint_path=_ckpt(checkpoint_dir, "lama.npz"),
                        config=cfg, device=device)
    for h, w in sizes:
        mask = np.zeros((h, w), np.uint8)
        mask[h // 2 : h // 2 + 8, w // 4 : w // 2] = 255
        # picture path (batch 1, full resolution)
        inp.inpaint(np.zeros((h, w, 3), np.uint8), mask)
        # video band path: one batch of BAND_BATCH frames at split_h = W*3/16
        split_h = int(w * 3 / 16)
        frames = [np.zeros((h, w, 3), np.uint8) for _ in range(BAND_BATCH)]
        full_mask = np.zeros((h, w, 1), np.uint8)
        mh = min(100, split_h - 8)  # a subtitle band's height at 720p+
        full_mask[h - 4 - mh : h - 4, w // 4 : w // 2] = 255
        inp(frames, full_mask)


def _warm_propainter(cfg: Config, checkpoint_dir: Optional[str],
                     sizes: Sequence[Tuple[int, int]],
                     clip_len: Optional[int], device: torch.device) -> None:
    from vsr_tpu_torch.inpaint.propainter import PropainterInpainter

    inp = PropainterInpainter(checkpoint_dir=checkpoint_dir, config=cfg, device=device)
    t = clip_len or cfg.propainter_max_load_num
    for h, w in sizes:
        split_h = int(w * 3 / 16)
        band_h = min(h, split_h + (-split_h) % 8)
        frames = [np.zeros((band_h, w, 3), np.uint8) for _ in range(t)]
        mask = np.zeros((band_h, w), np.uint8)
        mask[band_h // 3 : 2 * band_h // 3, w // 4 : 3 * w // 4] = 255
        inp.inpaint(frames, mask)


def warmup(
    modes: Iterable[str] = DEFAULT_MODES,
    sizes: Sequence[Tuple[int, int]] = DEFAULT_SIZES,
    checkpoint_dir: Optional[str] = None,
    config: Optional[Config] = None,
    clip_len: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> List[str]:
    """Build the native libraries (on CUDA) and run each mode once; returns
    the list of modes warmed. ``clip_len`` overrides the engine chunk length
    (tests use a tiny one; production leaves it None = configured gap)."""
    dev = resolve_device(device)
    cfg = config or Config()
    if dev.type == "cuda":
        build_native()
    done = []
    for mode in modes:
        t0 = time.perf_counter()
        if mode in ("sttn-auto", "sttn-det"):
            _warm_sttn(mode, cfg, checkpoint_dir, clip_len, dev)
        elif mode == "lama":
            _warm_lama(cfg, checkpoint_dir, sizes, dev)
        elif mode == "propainter":
            _warm_propainter(cfg, checkpoint_dir, sizes, clip_len, dev)
        elif mode == "opencv":
            continue  # host-only, nothing to run on the device
        else:
            raise ValueError(f"unknown warmup mode: {mode}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        _log(f"{mode}: ready in {time.perf_counter() - t0:.1f}s")
        done.append(mode)
    return done
