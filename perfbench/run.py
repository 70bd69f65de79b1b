"""Run one cell of the benchmark on cuda:0 and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the program of the cell's configuration on seeded weights, warms
every chunk shape its traffic uses, measures one closed-loop window of
``--seconds`` (a traced one with ``--trace 1``), checks sampled outputs
against the plain reference and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard error).

Exits non-zero without a result line where there is no CUDA card, fewer
cards than the cell asks for, or where a module of jax, jaxlib, flax or
vsr_tpu is loaded once the window has closed. Caches go inside the
checkout (``.perfbench_cache/``), temporary files under ``TMPDIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout; keep libraries from
    # loading jax on their own
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[perfbench] needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda:0", root=ROOT)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"[perfbench] forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"{name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
