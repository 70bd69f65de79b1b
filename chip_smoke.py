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
      chiprun_out/chip_smoke_profile.txt;
  (d) kernel route against plain route: one 50-frame chunk through the
      kernel and again with the model's token attention routed to
      token_attention_reference, in fp32 (max uint8 difference <= 2) and in
      bf16 (max and mean uint8 difference inside the mask, limits below).

The line before last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

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
SCALES = {"(5,3)": (1, 5120, 960), "(10,5)": (1, 1536, 3200)}
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
    for scale, (B, N, D) in SCALES.items():
        q, k, v = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(3))
        some = torch.where(torch.rand((B, N), generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0).float()
        every = torch.full((B, N), -1e9, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            for bias_name, bias in (("some keys masked", some), ("every key masked", every)):
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
            cases.append({"scale": scale, "dtype": name, "ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": bound_by, "library_ms": library_ms,
                          "library_backend": backend})
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


def check_frames(frames, out, mask):
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
        profile_main_path(inpainter, frames, mask, card)
        host_breakdown(inpainter, frames, mask)
    return launches, fps


def profile_main_path(inpainter, frames, mask, card):
    """Device time by kernel over one more 100-frame run (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, dt = run_video(inpainter, frames, mask)
    # device-side events only (kernels, memcpys, memsets): the CPU-side ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in events)
    lines = [f"{card}; torch.profiler over one run of {len(frames)} frames "
             f"(profiled wall {dt:.3f} s); device time {total / 1e3:.1f} ms"]
    for e in events:
        lines.append(f"{e.device_time_total / 1e3:10.2f} ms "
                     f"{100 * e.device_time_total / total:6.2f}% "
                     f"n={e.count:6d}  {e.key[:110]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_profile.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:16]:
        log(f"[c] profile: {line}")


def host_breakdown(inpainter, frames, mask):
    """Host wall time of one more 100-frame run, split by the host steps of
    process_video: band crop + resize, dispatch (H2D and launching the
    model), fetch (waiting for the device and D2H) and paste-back."""
    from vsr_tpu_torch.inpaint import sttn_auto

    totals = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    targets = [(inpainter, "_stack_band", "crop + resize"), (sttn_auto, "paste_band", "paste")]
    for engine in inpainter._engines.values():
        targets += [(engine, "dispatch", "dispatch"), (engine, "fetch", "fetch (device wait + D2H)")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    for obj, attr, name in targets:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    try:
        n, _, dt = run_video(inpainter, frames, mask)
    finally:
        for obj, attr, fn in saved:
            if obj is sttn_auto:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)  # back to the class's method
    rest = dt - sum(totals.values())
    log(f"[c] host time of {n} frames, {dt:.3f} s: " +
        ", ".join(f"{k} {v:.3f} s" for k, v in totals.items()) +
        f", other (reader, writer, loop) {rest:.3f} s")


def routes_u8_diff(dtype, frames, mask):
    """One chunk through the kernel and through the plain version."""
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.ops import patch_attention, token_attention

    inpainter = STTNAutoInpainter(config=Config(compute_dtype=dtype), device="cuda")
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
    inside = mask > 0
    diff = np.stack([np.abs(a.astype(int) - b.astype(int))[inside]
                     for a, b in zip(kernel_out, plain_out)])
    outside = max(int(np.abs(a.astype(int) - b.astype(int))[~inside].max())
                  for a, b in zip(kernel_out, plain_out))
    log(f"[d] {dtype} full width, {len(chunk)} frames: kernel route {dt_kernel:.2f} s, "
        f"plain route {dt_plain:.2f} s, uint8 difference inside the mask max "
        f"{int(diff.max())} mean {diff.mean():.4f}, outside max {outside}")
    if outside:
        raise AssertionError(f"[d] {dtype}: routes differ outside the mask")
    return int(diff.max()), float(diff.mean())


def phase_d(frames, mask):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32_max, _ = routes_u8_diff("float32", frames, mask)
    if f32_max > MAX_U8_DIFF:
        raise AssertionError(f"[d] fp32 kernel vs plain route differ by {f32_max} > {MAX_U8_DIFF}")
    bf16_max, bf16_mean = routes_u8_diff("bfloat16", frames, mask)
    if bf16_max > BF16_MAX_U8_DIFF or bf16_mean > BF16_MEAN_U8_DIFF:
        raise AssertionError(f"[d] bf16 kernel vs plain route: max {bf16_max} (limit "
                             f"{BF16_MAX_U8_DIFF}), mean {bf16_mean:.3f} (limit "
                             f"{BF16_MEAN_U8_DIFF})")
    return f32_max, bf16_max, bf16_mean


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vsr_tpu_torch.masks.mask import create_mask

    card = phase_a()
    max_err, cases = phase_b(card)
    frames = synthetic_video(N_FRAMES)
    mask = create_mask((H, W), [(300, 1620, 960, 1040)])  # bench.py's bottom band
    launches, fps = phase_c(card, frames, mask, "--profile" in argv)
    f32_diff, bf16_diff, bf16_mean = phase_d(frames, mask)
    main_case = [c for c in cases if c["dtype"] == "bfloat16"]

    def total(key):  # one transformer block's two kernel scales, as the main path calls them
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
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
