"""Readings for the limits of ``correct``: the program and the control on
many seeds, in one process on cuda:0.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 4] [--control-seconds 8] [--control-seeds N]

For each seed, one run of the cell (its window ``--seconds`` long) gives the
program's readings; then the control, the plain reference computed in
float8 e4m3 put in the program's place (``install_control`` of the cell's
driver), runs the same cell on the same seed and is compared in the same
way. Each run prints one JSON line ``{"seed", "side", "checks"}``; the last
line holds, for each check, the largest reading of the program and the
smallest of the control. The benchmark's own runs never run the control.

Where a configuration's control is the program's own lower-precision path
(``sttn-auto-fp32``'s is the bf16 program), read that path as its own cell
on the same seeds with ``--control-seeds 0``: ``sttn_auto.band_1080p``
computes the same frames with the same weights in bf16.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seconds", type=float, default=8.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    from perfbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    readings = {"program": {}, "control": {}}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        sides = [("program", args.seconds, None)]
        if args.control_seeds is None or i < args.control_seeds:
            sides.append(("control", args.control_seconds,
                          cell.driver.install_control))
        for side, seconds, hook in sides:
            result = harness.run_cell(args.workload, seed, seconds, False, device="cuda:0",
                                      root=ROOT, before_window=hook)
            checks = {k: c["value"] for k, c in result["checks"].items()}
            print(json.dumps({"seed": seed, "side": side, "attempted": result["attempted"],
                              "correct": result["correct"], "checks": checks}), flush=True)
            for k, v in checks.items():
                readings[side].setdefault(k, []).append(v)
    summary = {k: {"program_max": max(v),
                   "control_min": min(readings["control"].get(k, [float("nan")]))}
               for k, v in readings["program"].items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
