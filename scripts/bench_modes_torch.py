"""Per-mode warm throughput of the PyTorch/CUDA port -> JSON.

    python3 scripts/bench_modes_torch.py [--modes sttn-auto ...] [--trials 2]
                                         [--out FILE] [--device cpu]

The counterpart of scripts/bench_modes.py for vsr_tpu_torch: each inpaint
mode's warm throughput at one fixed geometry, 1280x720 frames under a
100 px subtitle band, through the port's STTNAutoInpainter, STTNDetInpainter,
LamaInpainter and PropainterInpainter ``__call__`` (full model width, seeded
random weights) on cuda:0, or on the CPU when asked (no fallback to it). One
full-length warm pass, then the best of ``--trials`` timed passes; every
wrapper returns host numpy frames, and the card is synchronised before and
after each pass. Each mode also records the token-attention kernel's
launches in a timed pass: above 0 for the STTN modes on the card, 0 for
LaMa and ProPainter (the script exits non-zero otherwise, or when a pass
returns other frames than it was given).

It writes bench_modes.py's JSON shape (geometry, dtype, device, modes), with
device the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

W, H = 1280, 720
BAND = (100, 1180, 600, 700)  # xmin, xmax, ymin, ymax

# frames per timed pass: long enough for pipelining to reach steady state,
# short enough that the slowest mode stays benchable
MODE_FRAMES = {
    "sttn-auto": 100,
    "sttn-det": 100,
    "lama": 48,
    "propainter": 48,
}
STTN_MODES = ("sttn-auto", "sttn-det")


def make_frames(n: int) -> list:
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return [np.roll(base, 5 * i, axis=1) for i in range(n)]


def build(mode: str, cfg, device):
    if mode == "sttn-auto":
        from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter

        return STTNAutoInpainter(config=cfg, device=device)
    if mode == "sttn-det":
        from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter

        return STTNDetInpainter(config=cfg, device=device)
    if mode == "lama":
        from vsr_tpu_torch.inpaint.lama import LamaInpainter

        return LamaInpainter(config=cfg, device=device)
    if mode == "propainter":
        from vsr_tpu_torch.inpaint.propainter import PropainterInpainter

        return PropainterInpainter(config=cfg, device=device)
    raise ValueError(mode)


def device_label(device) -> str:
    """The card's name and power limit from nvidia-smi; "cpu" on the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0].strip()


def bench_mode(mode: str, trials: int, device) -> dict:
    import torch

    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.masks.mask import create_mask
    from vsr_tpu_torch.ops import token_attention

    def timed_pass():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = model(frames, mask)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if len(out) != n or any(o.shape != f.shape or o.dtype != np.uint8
                                for o, f in zip(out, frames)):
            raise AssertionError(f"{mode}: a pass returned other frames than it was given")
        return dt

    cfg = Config()
    cfg.compute_dtype = os.environ.get("VSR_BENCH_DTYPE", "bfloat16")
    n = MODE_FRAMES[mode]
    frames = make_frames(n)
    mask = create_mask((H, W), [BAND])

    torch.manual_seed(0)
    model = build(mode, cfg, device)
    warm_s = timed_pass()
    best, launches = float("inf"), None
    for _ in range(trials):
        token_attention.launches = 0
        best = min(best, timed_pass())
        launches = token_attention.launches
    if device.type == "cuda" and (launches > 0) != (mode in STTN_MODES):
        raise AssertionError(f"{mode}: {launches} token-attention launches in a timed pass")
    return {
        "fps": round(n / best, 2),
        "frames": n,
        "best_pass_s": round(best, 3),
        "first_pass_s": round(warm_s, 1),
        "trials": trials,
        "kernel_launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="*", default=list(MODE_FRAMES))
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default cuda:0; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from vsr_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    results = {
        "geometry": f"{W}x{H} band {BAND}",
        "dtype": os.environ.get("VSR_BENCH_DTYPE", "bfloat16"),
        "device": device_label(device),
        "modes": {},
    }
    for mode in args.modes:
        r = bench_mode(mode, args.trials, device)
        results["modes"][mode] = r
        print(f"{mode}: {r['fps']} fps warm (first pass {r['first_pass_s']}s, "
              f"kernel launches {r['kernel_launches']}) on {results['device']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
