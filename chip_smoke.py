"""On-card smoke test of the PyTorch/CUDA port (vsr_tpu_torch), at full width.

    python3 chip_smoke.py [--profile]

Needs one NVIDIA Hopper GPU, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and
g++. Phases, each of which raises on failure (the script then exits
non-zero and prints no result line):

  (a) card and build: the card's name and power limit from nvidia-smi, then
      the CUDA kernels built from vsr_tpu_torch/csrc with nvcc for sm_90a
      and ptxas's register, spill and wgmma notes;
  (b) kernel against plain version: flash_token_attention against
      token_attention_reference at the sttn-auto scales (5,3) (N=5120,
      D=960) and (10,5) (N=1536, D=3200), fp32 (TF32 off) and bf16, with a
      bias masking some keys and one masking every key; max error and, in
      bf16, the error's norm against the output's, each held to a limit
      below (kernel_faults.py shows the norm check catching faults that
      the element-wise one misses); each side's time, the bound (the larger of 4 N^2 D over the peak rate and
      the bytes of q, k, v, bias and out over the memory rate), and the time
      of torch's scaled_dot_product_attention with the same float mask
      (library_ms, the yardstick; the port never calls it) with the backend
      that served it;
  (c) the main path: STTNAutoInpainter.process_video in bf16 on 100
      synthetic 1920x1080 frames (2 chunks of 50) under the bottom-band
      subtitle mask, full model width, seeded random weights, three timed
      runs after a warm one; frames in == frames out, pixels outside the
      mask bit-identical, pixels inside changed, kernel launches == 2
      scales x 8 blocks x windows x chunks in every run; frames/s. With
      --profile, a torch.profiler table of one more run goes to
      chiprun_out/chip_smoke_profile.txt, and the host time of another is
      split by step (as for phase f, into chip_smoke_profile_sttn_det.txt);
  (d) kernel route against plain route: one 50-frame chunk through the
      kernel and again with the model's token attention routed to
      token_attention_reference, in fp32 (max uint8 difference <= 2) and in
      bf16 (max and mean uint8 difference inside the mask, limits below);
  (e) detection at full width: a synthetic 100-frame 1920x1080 30 fps mp4
      (written with cv2, subtitle text on frames 11-40 and 61-70) through
      SubtitleDetector.find_subtitle_frame_no (PP-OCRv5 server DBNet,
      seeded random weights, fp32 with cuDNN's TF32 off, as the detector
      runs it), timed after a warm call; one frame's probability map
      against the same weights on the CPU in fp32 (max |err| <= DET_TOL),
      and, for the record only, with TF32 on; the boxes found;
  (f) the sttn-det main path: STTNDetInpainter.__call__ in bf16 on the 100
      frames of (c) under the same mask, three timed runs after a warm one
      (frames in == frames out, outside the mask bit-identical, inside
      changed, kernel launches == 8 blocks x windows x chunks, all at the
      (9,5) scale); then SubtitleRemover(..., device="cuda").run() in
      sttn-det mode on the mp4, with the detector replaced by a fixed
      frame -> boxes map (random DBNet weights find no real text; (e) ran
      the real one), launches counted the same way, frames and size of the
      output checked;
  (g) the det route check: one 50-frame chunk through STTNDetInpainter with
      the kernel and with token_attention_reference, fp32 within 2 uint8,
      bf16 within phase d's max and mean limits.

Phase b also runs the kernel at STTN-det's (9,5) scale (N = 2304, and 1728
for a short range's chunk; D = 2880) with, besides the two biases above,
the det variant's patch gating on top of padded frames.

The line before last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch import nn

W, H = 1920, 1080
N_FRAMES = 100  # two chunks of clip_gap = 50
MAIN_RUNS = 3
SEED = 0
F32_TOL, BF16_TOL = 2e-5, 2e-2  # |err| <= tol * (1 + |ref|), as tests/test_pallas_attention.py
# bf16 also: ||got - ref|| / ||ref|| <= BF16_REL. The element-wise bound above
# is about as large as a typical output here (~0.014 to 0.05 with randn
# inputs, N = 1536 to 5120 keys), so a fault in one key tile's rescale in the
# merge of the tiles' partial sums moves the outputs by a few 1e-3 and slips
# under it. The norm of the error sees such a fault; a correct kernel stays
# near bf16's rounding of its output (PERF.md has both).
BF16_REL = 1e-2
SCALES = {"(5,3)": (1, 5120, 960), "(10,5)": (1, 1536, 3200)}  # sttn-auto
# sttn-det: N = L * 144 with L = 16 (a 50-frame chunk) and L = 12 (a chunk of
# 20 frames or fewer); 1728 is no multiple of the 256-row score tile
DET_SCALES = {"(9,5)": (1, 2304, 2880), "(9,5) N=1728": (1, 1728, 2880)}
# the detector's probability map on the card (fp32, TF32 off) against the
# CPU: the repo's activation-parity bound (ROADMAP.md), which the card's
# other summation order should stay far inside
DET_TOL = 1e-3
DET_FPS = 30
SUB_FRAMES = {range(11, 41): (560, 1360, 950, 1010), range(61, 71): (640, 1280, 940, 1000)}
MAX_U8_DIFF = 2  # fp32: kernel route against plain route
# bf16, inside the mask: the kernel rounds p to bf16 before p v, the plain
# route does not, and 8 blocks of bf16 activations carry the difference to
# the decoder. Measured on an H100 (PERF.md), max / mean: 4 / 0.109 with the
# previous mma.sync kernel of the same contract, 4 / 0.109 with this one.
# Twice the max and ~5x the mean leave room for other seeds and cards and
# still catch a wrong kernel (which moves the mean by tens of uint8).
BF16_MAX_U8_DIFF, BF16_MEAN_U8_DIFF = 8, 0.5
# NVIDIA's data sheet for the H100 SXM, dense: bf16 on the tensor cores,
# fp32 outside them, and the HBM3 rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MEM_BYTES_PER_S = 3.35e12
OUT_DIR = "chiprun_out"


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
    """Mean device time of fn() over iters back-to-back launches (after one
    warm call). The card first spins for a few ms, so that every launch is
    queued before it starts and host gaps between calls are not counted."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time to enqueue fn() (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / iters


def bound_ms(B: int, N: int, D: int, dtype: str):
    """Least time the card could take for one call, and what sets it."""
    flops = 4.0 * B * N * N * D
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 4.0 * B * N * D * elem + 4.0 * B * N  # q, k, v read, out written; fp32 bias
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare(got, ref):
    """max |got - ref|, ||got - ref|| / ||ref||, and the checks that failed:
    finite values, within tol * (1 + |ref|) element-wise, and in bf16 within
    BF16_REL in norm."""
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return float("nan"), float("nan"), ["non-finite output"]
    err = (got - ref).abs()
    rel = ((got - ref).norm() / ref.norm()).item()
    tol = BF16_TOL if bf16 else F32_TOL
    failed = []
    if (err - tol * (1 + ref.abs())).max().item() > 0:
        failed.append(f"|err| over {tol:g}*(1+|ref|)")
    if bf16 and rel > BF16_REL:
        failed.append(f"||err||/||ref|| over {BF16_REL:g}")
    return err.max().item(), rel, failed


def library_call(q, k, v, bias):
    """torch's scaled_dot_product_attention with the same float mask and
    1/sqrt(D) scale, on the first backend that takes these shapes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    mask = bias[:, None, None, :].to(q.dtype)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return sdpa(q[:, None], k[:, None], v[:, None], attn_mask=mask)[:, 0]
        try:
            out = call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, call, out
    raise RuntimeError("no scaled_dot_product_attention backend took these inputs")


def device_split(fn, iters: int = 10):
    """Mean device time of each CUDA kernel fn() runs (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    def short(key):  # a kernel's own name: the identifier before its template or arguments
        m = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
        return m.group(1) if m else key

    return {short(e.key): e.device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


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
        if any(w in line for w in ("registers", "spill", "wgmma", "setmaxnreg")):
            log(f"[a] ptxas: {line.strip()}")
    return card


def phase_b(card):
    from vsr_tpu_torch.ops.token_attention import (
        flash_token_attention, token_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, []
    for scale, (B, N, D) in {**SCALES, **DET_SCALES}.items():
        q, k, v = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(3))
        some = torch.where(torch.rand((B, N), generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0).float()
        every = torch.full((B, N), -1e9, device="cuda")
        biases = [("some keys masked", some), ("every key masked", every)]
        if scale in DET_SCALES:
            biases.append(("patch gating", det_bias(B, N // 144).cuda()))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            for bias_name, bias in biases:
                got = flash_token_attention(qd, kd, vd, bias)
                ref = token_attention_reference(qd, kd, vd, bias)
                max_err, rel, failed = compare(got, ref)
                worst = max(worst, max_err)
                log(f"[b] {scale} B={B} N={N} D={D} {name} {bias_name}: "
                    f"max |err| {max_err:.3e}, ||err||/||ref|| {rel:.3e}")
                if failed:
                    raise AssertionError(f"[b] {scale} {dtype} {bias_name}: " + ", ".join(failed))
            backend, library, lib_out = library_call(qd, kd, vd, some)
            lib_err = (lib_out.float() - token_attention_reference(qd, kd, vd, some).float()
                       ).abs().max().item()
            kernel_ms = cuda_ms(lambda: flash_token_attention(qd, kd, vd, some), 10)
            plain_ms = cuda_ms(lambda: token_attention_reference(qd, kd, vd, some), 10)
            library_ms = cuda_ms(library, 10)
            bms, bound_by = bound_ms(B, N, D, name)
            split = device_split(lambda: flash_token_attention(qd, kd, vd, some))
            enqueue_ms = host_ms(lambda: flash_token_attention(qd, kd, vd, some), 10)
            log(f"[b] {scale} {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms (sdpa {backend}, max |err| {lib_err:.2e}), "
                f"bound {bms:.4f} ms ({bound_by}), kernel at {100 * bms / kernel_ms:.1f}% "
                f"of bound, on {card}")
            log(f"[b] {scale} {name}: device time by kernel (profiler) " +
                ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) +
                f"; host time to enqueue a call {enqueue_ms:.4f} ms")
            cases.append({"scale": scale, "path": "sttn-det" if scale in DET_SCALES else "sttn-auto",
                          "N": N, "D": D, "dtype": name, "ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": bound_by, "library_ms": library_ms,
                          "library_backend": backend})
    return worst, cases


def det_bias(B, L, padded=3):
    """The sttn-det (9,5) key bias as ops/patch_attention.py builds it: 144
    tokens (12 x 12) a frame, the last ``padded`` frames padded slots
    (-1e9), and the tokens whose patch lies mostly in a bottom-band hole
    (rows 7-9, columns 2-10 of the frame's grid) gated (-1e9): keys that
    are both carry -2e9."""
    gated = torch.zeros((12, 12), dtype=torch.bool)
    gated[7:10, 2:11] = True
    frame = torch.where(torch.arange(L) < L - padded, 0.0, -1e9)[:, None]
    bias = frame + torch.where(gated.reshape(-1), -1e9, 0.0)[None, :]
    return bias.reshape(1, -1).expand(B, -1).contiguous().float()


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


def check_frames(frames, out, mask, phase="c"):
    inside = mask > 0
    changed = 0
    for src, got in zip(frames, out):
        if got.shape != src.shape or got.dtype != np.uint8:
            raise AssertionError(f"[{phase}] frame {got.shape} {got.dtype}, "
                                 f"expected {src.shape} uint8")
        if not np.array_equal(got[~inside], src[~inside]):
            raise AssertionError(f"[{phase}] pixels outside the mask changed")
        changed += int(np.any(got[inside] != src[inside]))
    if changed != len(frames):
        raise AssertionError(f"[{phase}] only {changed}/{len(frames)} frames changed "
                             "inside the mask")


def phase_c(card, frames, mask, profile):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.ops import token_attention

    cfg = Config(compute_dtype="bfloat16")
    inpainter = STTNAutoInpainter(config=cfg, device="cuda")
    clip = inpainter.clip_gap
    n, _, dt = run_video(inpainter, frames[:clip], mask)  # warm: cuDNN plans, allocator
    log(f"[c] warm pass: {n} frames in {dt:.2f} s")

    fps = []
    for run in range(MAIN_RUNS):
        token_attention.launches = 0
        n, out, dt = run_video(inpainter, frames, mask)
        launches = token_attention.launches
        engine = next(iter(inpainter._engines.values()))
        chunks = -(-len(frames) // clip)
        want = 2 * len(inpainter.model.transformer) * engine.num_windows * chunks
        log(f"[c] main path run {run + 1}: {n} frames, {chunks} chunks of {clip}, "
            f"{engine.num_windows} windows/chunk, kernel launches {launches} (expected {want})")
        if n != len(frames) or len(out) != len(frames):
            raise AssertionError(f"[c] wrote {n} frames ({len(out)} kept) of {len(frames)}")
        if launches != want or launches == 0:
            raise AssertionError(f"[c] kernel launches {launches}, expected {want}")
        check_frames(frames, out, mask)
        fps.append(n / dt)
        log(f"[c] sttn-auto 1080p bf16 run {run + 1}: {fps[-1]:.2f} frames/s "
            f"({dt:.3f} s for {n} frames) on {card}")
    if profile:
        from vsr_tpu_torch.inpaint import sttn_auto

        def run():
            return run_video(inpainter, frames, mask)

        profile_run(run, len(frames), card, "c", "chip_smoke_profile.txt")
        host_breakdown(run, len(frames), [
            (inpainter, "_stack_band", "crop + resize"), (sttn_auto, "paste_band", "paste"),
            *engine_targets(inpainter)], "c")
    return launches, fps


def profile_run(run, n, card, phase, out_name):
    """Device time by kernel over one more n-frame run() (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = timed(run)
    # device-side events only (kernels, memcpys, memsets): the CPU-side ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in events)
    lines = [f"{card}; torch.profiler over one run of {n} frames "
             f"(profiled wall {dt:.3f} s); device time {total / 1e3:.1f} ms"]
    for e in events:
        lines.append(f"{e.device_time_total / 1e3:10.2f} ms "
                     f"{100 * e.device_time_total / total:6.2f}% "
                     f"n={e.count:6d}  {e.key[:110]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:16]:
        log(f"[{phase}] profile: {line}")


def host_breakdown(run, n, targets, phase):
    """Host wall time of one more n-frame run(), split by the host steps in
    ``targets`` [(object, attribute, label)]: each is wrapped in a timer
    for the run; the rest is reported as other."""
    totals = {}

    def timed_step(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    saved = [(obj, attr, getattr(obj, attr), attr in vars(obj)) for obj, attr, _ in targets]
    for obj, attr, name in targets:
        setattr(obj, attr, timed_step(name, getattr(obj, attr)))
    try:
        _, dt = timed(run)
    finally:
        for obj, attr, fn, own in saved:
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)  # back to the class's method
    rest = dt - sum(totals.values())
    log(f"[{phase}] host time of {n} frames, {dt:.3f} s: " +
        ", ".join(f"{k} {v:.3f} s" for k, v in totals.items()) +
        f", other {rest:.3f} s")


def engine_targets(inpainter):
    out = []
    for engine in inpainter._engines.values():
        out += [(engine, "dispatch", "dispatch"), (engine, "fetch", "fetch (device wait + D2H)")]
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def routes_u8_diff(phase, dtype, run, mask):
    """run() -> one chunk's output frames, once through the kernel and once
    with the model's token attention routed to its plain version."""
    from vsr_tpu_torch.ops import patch_attention, token_attention

    before = token_attention.launches
    kernel_out, dt_kernel = timed(run)
    if token_attention.launches == before:
        raise AssertionError(f"[{phase}] kernel route launched no kernel")
    patch_attention.flash_token_attention = token_attention.token_attention_reference
    try:
        before = token_attention.launches
        plain_out, dt_plain = timed(run)
        if token_attention.launches != before:
            raise AssertionError(f"[{phase}] plain route launched the kernel")
    finally:
        patch_attention.flash_token_attention = token_attention.flash_token_attention
    inside = mask > 0
    diff = np.stack([np.abs(a.astype(int) - b.astype(int))[inside]
                     for a, b in zip(kernel_out, plain_out)])
    outside = max(int(np.abs(a.astype(int) - b.astype(int))[~inside].max())
                  for a, b in zip(kernel_out, plain_out))
    log(f"[{phase}] {dtype} full width, {len(kernel_out)} frames: kernel route "
        f"{dt_kernel:.2f} s, plain route {dt_plain:.2f} s, uint8 difference inside the "
        f"mask max {int(diff.max())} mean {diff.mean():.4f}, outside max {outside}")
    if outside:
        raise AssertionError(f"[{phase}] {dtype}: routes differ outside the mask")
    return int(diff.max()), float(diff.mean())


def check_routes(phase, make_run, mask):
    """fp32 within MAX_U8_DIFF, bf16 within the max and mean limits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32_max, _ = routes_u8_diff(phase, "float32", make_run("float32"), mask)
    if f32_max > MAX_U8_DIFF:
        raise AssertionError(f"[{phase}] fp32 kernel vs plain route differ by {f32_max} "
                             f"> {MAX_U8_DIFF}")
    bf16_max, bf16_mean = routes_u8_diff(phase, "bfloat16", make_run("bfloat16"), mask)
    if bf16_max > BF16_MAX_U8_DIFF or bf16_mean > BF16_MEAN_U8_DIFF:
        raise AssertionError(f"[{phase}] bf16 kernel vs plain route: max {bf16_max} (limit "
                             f"{BF16_MAX_U8_DIFF}), mean {bf16_mean:.3f} (limit "
                             f"{BF16_MEAN_U8_DIFF})")
    return f32_max, bf16_max, bf16_mean


def phase_d(frames, mask):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter

    def make_run(dtype):
        inpainter = STTNAutoInpainter(config=Config(compute_dtype=dtype), device="cuda")
        return lambda: run_video(inpainter, frames[:inpainter.clip_gap], mask)[1]

    return check_routes("d", make_run, mask)


def subtitle_video(path, n):
    """An n-frame 1920x1080 mp4 (cv2, mp4v): a drifting colour gradient with
    a subtitle line drawn on the frames of SUB_FRAMES."""
    import cv2

    yy, xx = np.mgrid[0:H, 0:W + 4 * n].astype(np.float32)
    base = np.stack([(xx * 0.11 + yy * 0.05) % 256, (xx * 0.07 + 80) % 256,
                     (yy * 0.2 + xx * 0.02) % 256], axis=-1).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), DET_FPS, (W, H))
    try:
        for i in range(1, n + 1):
            frame = np.ascontiguousarray(base[:, 4 * i:4 * i + W])
            for frames, (xmin, xmax, ymin, ymax) in SUB_FRAMES.items():
                if i in frames:
                    cv2.putText(frame, f"synthetic subtitle line {i}", (xmin + 10, ymax - 15),
                                cv2.FONT_HERSHEY_SIMPLEX, 1.6, (255, 255, 255), 4)
            writer.write(frame)
    finally:
        writer.release()


def phase_e(card, video):
    """Detection at full width (see the module docstring)."""
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.detect.dbnet import DBNet
    from vsr_tpu_torch.detect.detector import SubtitleDetector
    from vsr_tpu_torch.detect.postprocess import db_postprocess
    from vsr_tpu_torch.detect.preprocess import preprocess_frame
    from vsr_tpu_torch.io.video import VideoReader

    det = SubtitleDetector(video, config=Config(), device="cuda")
    (_, dt_warm) = timed(det.find_subtitle_frame_no)
    found, dt = timed(det.find_subtitle_frame_no)
    sampled = len(range(0, N_FRAMES, det.sample_step))
    log(f"[e] find_subtitle_frame_no, {N_FRAMES} frames {W}x{H} at {DET_FPS} fps, 1 in "
        f"{det.sample_step} sampled ({sampled} frames, batches of {det.batch_size}): "
        f"{dt:.3f} s ({sampled / dt:.2f} sampled frames/s; warm call {dt_warm:.3f} s) on {card}")
    log(f"[e] frames with boxes: {len(found)}; boxes: "
        f"{sorted({b for boxes in found.values() for b in boxes})[:8]}")

    reader = VideoReader(video)
    for _ in range(15):  # frame 15 carries the subtitle line
        ok, frame = reader.read()
    reader.release()
    batch = preprocess_frame(frame)[None]
    got = det.probability_maps(batch)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = det.model(torch.from_numpy(batch).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu_model = DBNet().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in det.model.state_dict().items()})
    flops = []
    hooks = [m.register_forward_hook(lambda m, i, o: flops.append(conv_flops(m, i[0], o)))
             for m in cpu_model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.inference_mode():
        want, dt_cpu = timed(lambda: cpu_model(torch.from_numpy(batch)).numpy())
    for h in hooks:
        h.remove()
    gflop = sum(flops) / 1e9
    err, err_tf32 = float(np.abs(got - want).max()), float(np.abs(tf32 - want).max())
    boxes = [q.astype(int).tolist() for q in db_postprocess(got[0, ..., 0], frame.shape[:2])]
    log(f"[e] frame 15 at {batch.shape[1]}x{batch.shape[2]}: probability map in "
        f"[{got.min():.4f}, {got.max():.4f}], max |card - CPU| {err:.3e} (TF32 off, limit "
        f"{DET_TOL:g}), {err_tf32:.3e} with TF32 on (not used); CPU forward {dt_cpu:.2f} s; "
        f"boxes {boxes}")
    if not np.isfinite(got).all() or err > DET_TOL:
        raise AssertionError(f"[e] detector on the card vs CPU: max |err| {err} > {DET_TOL}")

    x = torch.from_numpy(np.repeat(batch, det.batch_size, axis=0)).cuda()
    with torch.inference_mode():
        torch.backends.cudnn.allow_tf32 = True
        fwd_tf32_ms = cuda_ms(lambda: det.model(x), 5)
        torch.backends.cudnn.allow_tf32 = False
        fwd_ms = cuda_ms(lambda: det.model(x), 5)
    post_ms = 1e3 * timed(lambda: [db_postprocess(got[0, ..., 0], frame.shape[:2])
                                   for _ in range(10)])[1] / 10
    log(f"[e] DBNet forward, batch {det.batch_size} at {batch.shape[1]}x{batch.shape[2]}, "
        f"fp32 TF32 off: {fwd_ms:.2f} ms device time ({fwd_ms / det.batch_size:.2f} ms a "
        f"frame; {fwd_tf32_ms:.2f} ms with TF32 on, not used); {gflop:.1f} GFLOP a frame "
        f"in its convolutions, {gflop * det.batch_size / fwd_ms:.1f} TFLOP/s; db_postprocess "
        f"{post_ms:.2f} ms a frame on the host, on {card}")
    return {"find_s": dt, "sampled_frames_per_s": sampled / dt, "max_abs_err_vs_cpu": err,
            "max_abs_err_vs_cpu_tf32": err_tf32, "forward_ms_batch8": fwd_ms,
            "forward_ms_batch8_tf32": fwd_tf32_ms, "gflop_per_frame": gflop,
            "postprocess_ms": post_ms, "frames_with_boxes": len(found)}


def conv_flops(m, x, out) -> int:
    """Multiply-adds x 2 of one Conv2d / ConvTranspose2d call."""
    if isinstance(m, nn.ConvTranspose2d):  # every input pixel meets the whole kernel
        taps = m.out_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
        return 2 * x.numel() * taps
    return 2 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]


class FixedDetector:
    """A fixed frame -> boxes map in place of the DBNet detector."""

    def find_subtitle_frame_no(self, sub_remover=None):
        return {f: [box] for frames, box in SUB_FRAMES.items() for f in frames}


def expected_det_launches(model, chunks_clips, stride):
    """8 blocks x windows per chunk, summed over the (chunk frames, clip)
    pairs that ran."""
    return len(model.transformer) * sum(-(-clip // stride) for _, clip in chunks_clips)


def phase_f(card, frames, mask, video, tmp, profile):
    from vsr_tpu_torch.config import Config, InpaintMode
    from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter
    from vsr_tpu_torch.io.video import read_video_info
    from vsr_tpu_torch.masks.intervals import (
        batch_generator, expand_frame_ranges, filter_and_merge_intervals,
        find_continuous_ranges_with_same_mask)
    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.pipeline import SubtitleRemover

    cfg = Config(compute_dtype="bfloat16")
    inpainter = STTNDetInpainter(config=cfg, device="cuda")
    _, dt = timed(lambda: inpainter(frames[:50], mask))
    log(f"[f] warm pass: 50 frames in {dt:.2f} s")
    clip = cfg.get_sttn_max_load_num()
    chunks = [(len(frames[s:s + clip]), clip) for s in range(0, len(frames), clip)]
    want = expected_det_launches(inpainter.model, chunks, cfg.sttn_neighbor_stride)
    fps = []
    for run in range(MAIN_RUNS):
        token_attention.launches = 0
        out, dt = timed(lambda: inpainter(frames, mask))
        launches = token_attention.launches
        log(f"[f] sttn-det run {run + 1}: {len(out)} frames, {len(chunks)} chunks of {clip}, "
            f"kernel launches {launches} (expected {want})")
        if len(out) != len(frames):
            raise AssertionError(f"[f] {len(out)} frames out of {len(frames)}")
        if launches != want or launches == 0:
            raise AssertionError(f"[f] kernel launches {launches}, expected {want}")
        check_frames(frames, out, mask, "f")
        fps.append(len(out) / dt)
        log(f"[f] sttn-det {W}x{H} bf16 run {run + 1}: {fps[-1]:.2f} frames/s "
            f"({dt:.3f} s for {len(out)} frames) on {card}")
    if profile:
        from vsr_tpu_torch.inpaint import sttn_det

        profile_run(lambda: inpainter(frames, mask), len(frames), card, "f",
                    "chip_smoke_profile_sttn_det.txt")
        host_breakdown(lambda: inpainter(frames, mask), len(frames), [
            (sttn_det.cv2, "resize", "crop + resize (cv2)"), (sttn_det, "paste_band", "paste"),
            *engine_targets(inpainter)], "f")

    out_path = os.path.join(tmp, "sttn_det_out.mp4")
    remover = SubtitleRemover(video, output_path=out_path,
                              config=Config(compute_dtype="bfloat16",
                                            inpaint_mode=InpaintMode.STTN_DET),
                              device="cuda")
    remover._detector = FixedDetector()
    sub_list = remover._detector.find_subtitle_frame_no()
    ranges = filter_and_merge_intervals(expand_frame_ranges(
        find_continuous_ranges_with_same_mask(sub_list),
        cfg.subtitle_timeline_backward_frame_count, cfg.subtitle_timeline_forward_frame_count),
        cfg.sttn_reference_length)
    runs = []
    for s, e in ranges:
        for batch in batch_generator(range(s, e + 1), clip):
            t = len(batch)
            runs.append((t, min(clip, max(t, cfg.sttn_reference_length))))
    want = expected_det_launches(inpainter.model, runs, cfg.sttn_neighbor_stride)
    token_attention.launches = 0
    _, dt = timed(remover.run)
    launches = token_attention.launches
    info = read_video_info(out_path)
    log(f"[f] SubtitleRemover.run() sttn-det on the mp4: ranges {ranges}, chunks (frames, "
        f"clip) {runs}, token counts N {sorted({144 * (11 + -(-c // 10)) for _, c in runs})}, "
        f"kernel launches {launches} (expected {want}); {info.frame_count} frames "
        f"{info.width}x{info.height} written in {dt:.2f} s ({N_FRAMES / dt:.2f} frames/s end "
        f"to end, mp4v) on {card}")
    if launches != want or launches == 0:
        raise AssertionError(f"[f] remover kernel launches {launches}, expected {want}")
    if (info.frame_count, info.width, info.height) != (N_FRAMES, W, H):
        raise AssertionError(f"[f] output {info}, expected {N_FRAMES} frames {W}x{H}")
    return want, fps


def phase_g(frames, mask):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter

    def make_run(dtype):
        inpainter = STTNDetInpainter(config=Config(compute_dtype=dtype), device="cuda")
        return lambda: inpainter(frames[:50], mask)

    return check_routes("g", make_run, mask)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vsr_tpu_torch.masks.mask import create_mask

    t0 = time.perf_counter()

    def done(phase):
        log(f"[{phase}] done at {time.perf_counter() - t0:.1f} s")

    card = phase_a()
    max_err, cases = phase_b(card)
    done("b")
    frames = synthetic_video(N_FRAMES)
    mask = create_mask((H, W), [(300, 1620, 960, 1040)])  # bench.py's bottom band
    launches, fps = phase_c(card, frames, mask, "--profile" in argv)
    done("c")
    f32_diff, bf16_diff, bf16_mean = phase_d(frames, mask)
    done("d")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        video = os.path.join(tmp, "subtitles.mp4")
        subtitle_video(video, N_FRAMES)
        detection = phase_e(card, video)
        done("e")
        det_launches, det_fps = phase_f(card, frames, mask, video, tmp, "--profile" in argv)
        done("f")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    det_f32, det_bf16, det_bf16_mean = phase_g(frames, mask)
    done("g")
    # one sttn-auto transformer block's two kernel scales, as that path calls them
    main_case = [c for c in cases if c["dtype"] == "bfloat16" and c["path"] == "sttn-auto"]

    def total(key):
        return sum(c[key] for c in main_case)

    print(json.dumps({"kernels": [{
        "name": "flash_token_attention",
        "route": "cuda",
        "source": "vsr_tpu_torch/csrc/token_attention.cu",
        "replaces": "vsr_tpu/ops/pallas_token_attention.py:150",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if all(c["bound_by"] == "operations" for c in main_case)
                    else "bytes",
        "library_ms": total("library_ms"),
        "cases": cases,
        "fps_1080p_bf16": fps,
        "full_width_u8_diff": {"float32": f32_diff, "bfloat16_max": bf16_diff,
                               "bfloat16_mean": bf16_mean},
        "launches_sttn_det": det_launches,
        "fps_1080p_bf16_sttn_det": det_fps,
        "full_width_u8_diff_sttn_det": {"float32": det_f32, "bfloat16_max": det_bf16,
                                        "bfloat16_mean": det_bf16_mean},
        "detection": detection,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
