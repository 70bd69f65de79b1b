"""Command line of the port:

    python -m vsr_tpu_torch -i in.mp4 [-o out.mp4] [-c YMIN YMAX XMIN XMAX ...]
                            [--inpaint-mode sttn-auto|sttn-det|opencv]
                            [--models DIR] [--device cuda]

The flags and defaults are those of ``vsr_tpu.cli`` plus ``--device``. Modes
(lama, propainter) and flags that are not ported yet exit with an error
naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from vsr_tpu_torch.config import Config, InpaintMode

DEFAULT_CONFIG_PATH = "config/config.json"  # reference convention

# flag -> ROADMAP.md Queue 1 item that ports it
_UNPORTED_FLAGS = {"check_update": "4", "warmup": "4", "prepare_models": "4",
                   "gui": "11"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vsr_tpu_torch",
        description="Video subtitle remover, PyTorch/CUDA port",
    )
    parser.add_argument("--input", "-i", type=str, default=None,
                        help="Input video/image file path (required unless "
                             "--check-update)")
    parser.add_argument("--output", "-o", type=str, default=None,
                        help="Output file path (optional)")
    parser.add_argument(
        "--subtitle-area-coords", "-c", action="append", nargs=4, type=int,
        metavar=("YMIN", "YMAX", "XMIN", "XMAX"),
        help="Subtitle area (repeatable for multiple areas)",
    )
    parser.add_argument(
        "--inpaint-mode", type=str, default="sttn-auto",
        choices=[m.value for m in InpaintMode],
        help="Inpaint mode (default: sttn-auto)",
    )
    parser.add_argument("--models", type=str, default=None,
                        help="Directory with converted model checkpoints (.npz)")
    parser.add_argument("--config", type=str, default=None,
                        help="Path to a config JSON")
    parser.add_argument("--lang", type=str, default=None,
                        help="UI locale (default: en, like the reference CLI; "
                             "see vsr_tpu_torch.i18n.available_locales())")
    parser.add_argument("--check-update", action="store_true",
                        help="Query the latest release and exit")
    parser.add_argument(
        "--warmup", nargs="*", metavar="MODE", default=None,
        help="Precompile the standard programs and exit; optional mode list")
    parser.add_argument(
        "--warmup-sizes", action="append", nargs=2, type=int,
        metavar=("H", "W"),
        help="Frame sizes to warm (repeatable; default 480p/720p/1080p)")
    parser.add_argument(
        "--prepare-models", type=str, default=None, metavar="REF_MODELS_DIR",
        help="One-shot model bootstrap: convert every reference checkpoint "
             "found under REF_MODELS_DIR into the --models directory, then exit.")
    parser.add_argument("--gui", action="store_true",
                        help="Launch the browser GUI instead of processing")
    parser.add_argument("--port", type=int, default=8123,
                        help="GUI port (with --gui)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda; cpu for tests)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, item in _UNPORTED_FLAGS.items():
        if getattr(args, flag) not in (None, False):
            parser.error(f"--{flag.replace('_', '-')} is not ported to vsr_tpu_torch "
                         f"yet (ROADMAP.md Queue 1 item {item})")
    from vsr_tpu_torch.pipeline import UNPORTED_MODES

    mode = InpaintMode(args.inpaint_mode)
    if mode in UNPORTED_MODES:
        parser.error(f"--inpaint-mode {mode.value} is not ported to vsr_tpu_torch yet "
                     f"(ROADMAP.md Queue 1 item {UNPORTED_MODES[mode]})")
    if not args.input:
        parser.error("--input/-i is required")
    # --config wins; otherwise the reference's config/config.json convention
    cfg = Config.load(args.config or DEFAULT_CONFIG_PATH)
    cfg.inpaint_mode = mode
    # the reference CLI forces the en locale (backend/main.py:476); --lang or
    # config.interface override
    from vsr_tpu_torch.i18n import set_locale

    set_locale(args.lang or cfg.interface or "en")

    from vsr_tpu_torch.pipeline import SubtitleRemover

    remover = SubtitleRemover(
        args.input,
        output_path=args.output,
        sub_areas=[tuple(c) for c in (args.subtitle_area_coords or [])],
        config=cfg,
        checkpoint_dir=args.models,
        device=args.device,
    )
    remover.run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
