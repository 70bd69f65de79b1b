"""Command line of the port:

    python -m vsr_tpu_torch -i in.mp4 [-o out.mp4] [-c YMIN YMAX XMIN XMAX ...]
                            [--inpaint-mode sttn-auto] [--models DIR] [--device cuda]

The flags are those of ``vsr_tpu.cli`` plus ``--device``. Modes and flags
that are not ported yet exit with an error naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import List, Optional

from vsr_tpu.cli import DEFAULT_CONFIG_PATH, build_parser as _build_parser
from vsr_tpu.config import Config, InpaintMode

# flag -> ROADMAP.md Queue 1 item that ports it
_UNPORTED_FLAGS = {"check_update": "4", "warmup": "4", "prepare_models": "4",
                   "gui": "11"}


def build_parser():
    parser = _build_parser()
    parser.prog = "vsr_tpu_torch"
    parser.description = "Video subtitle remover, PyTorch/CUDA port"
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
    cfg = Config.load(args.config or DEFAULT_CONFIG_PATH)
    cfg.inpaint_mode = mode
    from vsr_tpu.i18n import set_locale

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
