"""Command line of the port:

    python -m vsr_tpu_torch -i in.mp4 [-o out.mp4] [-c YMIN YMAX XMIN XMAX ...]
                            [--inpaint-mode sttn-auto|sttn-det|lama|propainter|opencv]
                            [--models DIR] [--device cuda]
    python -m vsr_tpu_torch -i picture.png [-o out.png]   (detection + LaMa;
                            default output no_sub/picture.png)
    python -m vsr_tpu_torch --prepare-models REF_MODELS_DIR [--models DIR]
    python -m vsr_tpu_torch --warmup [MODE ...] [--warmup-sizes H W] [--models DIR]
    python -m vsr_tpu_torch --check-update
    python -m vsr_tpu_torch --gui [--port 8123] [--config PATH] [--device cuda]
                            (browser GUI; task workers run on --device)

The flags and defaults are those of ``vsr_tpu.cli`` plus ``--device``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from vsr_tpu_torch.config import Config, InpaintMode

DEFAULT_CONFIG_PATH = "config/config.json"  # reference convention


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
        help="Build the native libraries and run each mode once, then exit; "
             "optional mode list (default: sttn-auto sttn-det lama). Add "
             "'propainter' explicitly.")
    parser.add_argument(
        "--warmup-sizes", action="append", nargs=2, type=int,
        metavar=("H", "W"),
        help="Frame sizes to warm (repeatable; default 480p/720p/1080p)")
    parser.add_argument(
        "--prepare-models", type=str, default=None, metavar="REF_MODELS_DIR",
        help="One-shot model bootstrap: merge split blobs and convert every "
             "reference checkpoint found under REF_MODELS_DIR (the "
             "reference's backend/models layout) into .npz files in the "
             "--models directory (default ./models_npz), then exit.")
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
    if args.check_update:
        from vsr_tpu_torch.utils.version_service import check_latest_release
        from vsr_tpu_torch.version import __version__

        info = check_latest_release()
        if info is None:
            print(f"vsr_tpu_torch {__version__}: release info unreachable")
        elif info["newer"]:
            print(f"vsr_tpu_torch {__version__}: update available "
                  f"{info['tag']} ({info['url']})")
        else:
            print(f"vsr_tpu_torch {__version__}: up to date ({info['tag']})")
        return 0
    if args.prepare_models is not None:
        from vsr_tpu_torch.prepare import prepare_models

        results = prepare_models(args.prepare_models,
                                 args.models or "models_npz")
        bad = [f for f, s in results.items() if s.startswith("error")]
        return 1 if bad else 0
    if args.warmup is not None:
        from vsr_tpu_torch.warmup import DEFAULT_MODES, DEFAULT_SIZES, warmup

        warmup(
            modes=args.warmup or DEFAULT_MODES,
            sizes=[tuple(s) for s in (args.warmup_sizes or DEFAULT_SIZES)],
            checkpoint_dir=args.models,
            config=Config.load(args.config or DEFAULT_CONFIG_PATH),
            device=args.device,
        )
        return 0
    if args.gui:
        from vsr_tpu_torch.gui.server import GuiServer

        GuiServer(port=args.port, config_path=args.config or DEFAULT_CONFIG_PATH,
                  device=args.device).serve_forever()
        return 0
    mode = InpaintMode(args.inpaint_mode)
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
