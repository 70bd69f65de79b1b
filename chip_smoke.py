"""On-card smoke test of the PyTorch/CUDA port (vsr_tpu_torch), at full width.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and
g++. Phases, each of which raises on failure (the script then exits
non-zero and prints no result line):

  (a) card and build: the card's name and power limit from nvidia-smi, then
      the CUDA kernels built from vsr_tpu_torch/csrc with nvcc for sm_90a;
  (b) kernel against plain version: flash_token_attention against
      token_attention_reference at the sttn-auto scales (5,3) (N=5120,
      D=960) and (10,5) (N=1536, D=3200), fp32 (TF32 off) and bf16, with a
      bias masking some keys and one masking every key; max error and
      each side's time;
  (c) the main path: STTNAutoInpainter.process_video in bf16 on 100
      synthetic 1920x1080 frames (2 chunks of 50) under the bottom-band
      subtitle mask, full model width, seeded random weights; frames in ==
      frames out, pixels outside the mask bit-identical, pixels inside
      changed, kernel launches == 2 scales x 8 blocks x windows run;
      frames/s;
  (d) kernel route against plain route: one 50-frame chunk in fp32 through
      the kernel and again with the model's token attention routed to
      token_attention_reference; max uint8 difference must be <= 2.

The line before last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

W, H = 1920, 1080
N_FRAMES = 100  # two chunks of clip_gap = 50
SEED = 0
F32_TOL, BF16_TOL = 2e-5, 2e-2  # |err| <= tol * (1 + |ref|), as tests/test_pallas_attention.py
SCALES = {"(5,3)": (1, 5120, 960), "(10,5)": (1, 1536, 3200)}
MAX_U8_DIFF = 2


def log(msg: str) -> None:
    print(msg, flush=True)


class ListReader:
    """read() -> (ok, frame) over an in-memory list; hands out copies."""

    def __init__(self, frames):
        self._frames, self._i = frames, 0

    def read(self):
        if self._i >= len(self._frames):
            return False, None
        self._i += 1
        return True, self._frames[self._i - 1].copy()


class ListWriter:
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_a():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    from vsr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.get_lib()
    log(f"[a] built {_build.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[a] ptxas: {line.strip()}")
    return card


def phase_b():
    from vsr_tpu_torch.ops.token_attention import (
        flash_token_attention, token_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, []
    for scale, (B, N, D) in SCALES.items():
        q, k, v = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(3))
        some = torch.where(torch.rand((B, N), generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0).float()
        every = torch.full((B, N), -1e9, device="cuda")
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            for bias_name, bias in (("some keys masked", some), ("every key masked", every)):
                got = flash_token_attention(qd, kd, vd, bias).float()
                ref = token_attention_reference(qd, kd, vd, bias).float()
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"[b] {scale} {dtype} {bias_name}: non-finite output")
                err = (got - ref).abs()
                bound = (tol * (1 + ref.abs())).min().item()
                excess = (err - tol * (1 + ref.abs())).max().item()
                max_err = err.max().item()
                worst = max(worst, max_err)
                log(f"[b] {scale} B={B} N={N} D={D} {str(dtype)[6:]} {bias_name}: "
                    f"max |err| {max_err:.3e} (tol {tol:g}*(1+|ref|), >= {bound:.1e})")
                if excess > 0:
                    raise AssertionError(f"[b] {scale} {dtype} {bias_name}: error over tolerance")
            kernel_ms = cuda_ms(lambda: flash_token_attention(qd, kd, vd, some), 10)
            plain_ms = cuda_ms(lambda: token_attention_reference(qd, kd, vd, some), 10)
            log(f"[b] {scale} {str(dtype)[6:]}: kernel {kernel_ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
            cases.append({"scale": scale, "dtype": str(dtype)[6:], "ms": kernel_ms,
                          "plain_ms": plain_ms})
    return worst, cases


def synthetic_video(n):
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return [np.roll(base, 7 * i, axis=1) for i in range(n)]


def run_video(inpainter, frames, mask):
    writer = ListWriter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = inpainter.process_video(ListReader(frames), writer, mask, len(frames), (W, H))
    torch.cuda.synchronize()
    return n, writer.frames, time.perf_counter() - t0


def phase_c(card, frames, mask):
    from vsr_tpu.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.ops import token_attention

    cfg = Config(compute_dtype="bfloat16")
    inpainter = STTNAutoInpainter(config=cfg, device="cuda")
    clip = inpainter.clip_gap
    n, _, dt = run_video(inpainter, frames[:clip], mask)  # warm: cuDNN plans, allocator
    log(f"[c] warm pass: {n} frames in {dt:.2f} s")

    token_attention.launches = 0
    n, out, dt = run_video(inpainter, frames, mask)
    launches = token_attention.launches
    engine = next(iter(inpainter._engines.values()))
    chunks = -(-len(frames) // clip)
    want = 2 * len(inpainter.model.transformer) * engine.num_windows * chunks
    log(f"[c] main path: {n} frames, {chunks} chunks of {clip}, {engine.num_windows} "
        f"windows/chunk, kernel launches {launches} (expected {want})")
    if n != len(frames) or len(out) != len(frames):
        raise AssertionError(f"[c] wrote {n} frames ({len(out)} kept) of {len(frames)}")
    if launches != want or launches == 0:
        raise AssertionError(f"[c] kernel launches {launches}, expected {want}")
    inside = mask > 0
    changed = 0
    for src, got in zip(frames, out):
        if got.shape != src.shape or got.dtype != np.uint8:
            raise AssertionError(f"[c] frame {got.shape} {got.dtype}, expected {src.shape} uint8")
        if not np.array_equal(got[~inside], src[~inside]):
            raise AssertionError("[c] pixels outside the mask changed")
        changed += int(np.any(got[inside] != src[inside]))
    if changed != len(frames):
        raise AssertionError(f"[c] only {changed}/{len(frames)} frames changed inside the mask")
    fps = n / dt
    log(f"[c] sttn-auto 1080p bf16: {fps:.2f} frames/s ({dt:.2f} s for {n} frames) "
        f"on {card}")
    return launches, fps


def phase_d(frames, mask):
    from vsr_tpu.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.ops import patch_attention, token_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inpainter = STTNAutoInpainter(config=Config(compute_dtype="float32"), device="cuda")
    chunk = frames[:inpainter.clip_gap]
    before = token_attention.launches
    _, kernel_out, dt_kernel = run_video(inpainter, chunk, mask)
    if token_attention.launches == before:
        raise AssertionError("[d] kernel route launched no kernel")
    patch_attention.flash_token_attention = token_attention.token_attention_reference
    try:
        before = token_attention.launches
        _, plain_out, dt_plain = run_video(inpainter, chunk, mask)
        if token_attention.launches != before:
            raise AssertionError("[d] plain route launched the kernel")
    finally:
        patch_attention.flash_token_attention = token_attention.flash_token_attention
    diff = max(int(np.abs(a.astype(int) - b.astype(int)).max())
               for a, b in zip(kernel_out, plain_out))
    log(f"[d] fp32 full width, {len(chunk)} frames: kernel route {dt_kernel:.2f} s, "
        f"plain route {dt_plain:.2f} s, max uint8 difference {diff}")
    if diff > MAX_U8_DIFF:
        raise AssertionError(f"[d] kernel vs plain route differ by {diff} > {MAX_U8_DIFF}")
    return diff


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vsr_tpu.masks.mask import create_mask

    card = phase_a()
    max_err, cases = phase_b()
    frames = synthetic_video(N_FRAMES)
    mask = create_mask((H, W), [(300, 1620, 960, 1040)])  # bench.py's bottom band
    launches, fps = phase_c(card, frames, mask)
    u8_diff = phase_d(frames, mask)
    main_case = [c for c in cases if c["dtype"] == "bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "flash_token_attention",
        "route": "cuda",
        "source": "vsr_tpu_torch/csrc/token_attention.cu",
        "replaces": "vsr_tpu/ops/pallas_token_attention.py:150",
        "launches": launches,
        "max_abs_err": max_err,
        # one transformer block's two kernel scales in bf16, as the main path calls them
        "ms": sum(c["ms"] for c in main_case),
        "plain_ms": sum(c["plain_ms"] for c in main_case),
        "cases": cases,
        "fps_1080p_bf16": fps,
        "full_width_u8_diff": u8_diff,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
