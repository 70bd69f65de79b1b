"""Checkpoint conversion CLI: reference torch/TorchScript/Paddle -> .npz.

    python -m vsr_tpu_torch.convert <family> <checkpoint> [-o out.npz]

The port's copy of ``python -m vsr_tpu.convert``; it needs torch and
numpy, not jax, and writes the same .npz. Families and their reference
checkpoints:
    sttn-auto        sttn-auto/infer_model.pth      (['netG'] state dict)
    sttn-det         sttn-det/sttn.pth
    lama             big-lama.pt                    (TorchScript blob or raw .pth)
    raft             propainter/raft-things.pth
    flow-completion  propainter/recurrent_flow_completion.pth
    propainter       propainter/ProPainter.pth
    dbnet-server     V5/ch_det/inference.pdiparams  (PP-HGNetV2-B4; needs paddle)
    dbnet-mobile     V5/ch_det_fast/inference.pdiparams (PP-LCNetV3; needs paddle)
    i3d              i3d_rgb_imagenet.pt            (VFID metric)
    vgg19 / vgg16    torchvision VGG checkpoints    (perceptual loss)
    lpips            lpips vgg checkpoint

The output .npz loads via --models DIR on the main CLI of either package
(expected filenames: sttn_auto.npz, sttn_det.npz, lama.npz, raft.npz,
flow_completion.npz, propainter.npz, dbnet.npz).
"""

from __future__ import annotations

import argparse
import os
import sys

_DEFAULT_NAME = {
    "sttn-auto": "sttn_auto.npz",
    "sttn-det": "sttn_det.npz",
    "lama": "lama.npz",
    "raft": "raft.npz",
    "flow-completion": "flow_completion.npz",
    "propainter": "propainter.npz",
    "dbnet-server": "dbnet.npz",
    "dbnet-mobile": "dbnet.npz",
    "i3d": "i3d.npz",
    "vgg19": "vgg19.npz",
    "vgg16": "vgg16.npz",
    "lpips": "lpips.npz",
}


def _load(family: str, path: str):
    if family in ("sttn-auto", "sttn-det"):
        from vsr_tpu_torch.convert.torch_sttn import load_sttn_checkpoint

        return load_sttn_checkpoint(path)
    if family == "lama":
        from vsr_tpu_torch.convert.torch_lama import load_lama_checkpoint

        return load_lama_checkpoint(path)
    if family == "raft":
        from vsr_tpu_torch.convert.torch_raft import load_raft_checkpoint

        return load_raft_checkpoint(path)
    if family == "flow-completion":
        import torch

        from vsr_tpu_torch.convert.torch_propainter import convert_flow_completion

        return convert_flow_completion(torch.load(path, map_location="cpu"))
    if family == "propainter":
        import torch

        from vsr_tpu_torch.convert.torch_propainter import convert_propainter_generator

        return convert_propainter_generator(torch.load(path, map_location="cpu"))
    if family in ("dbnet-server", "dbnet-mobile"):
        from vsr_tpu_torch.convert.paddle_dbnet import (
            convert_paddle_det_state_dict,
            load_pdiparams,
        )

        preset = "server" if family == "dbnet-server" else "mobile"
        return convert_paddle_det_state_dict(load_pdiparams(path), preset)
    if family == "i3d":
        from vsr_tpu_torch.convert.torch_i3d import load_i3d_checkpoint

        return load_i3d_checkpoint(path)
    if family in ("vgg19", "vgg16"):
        from vsr_tpu_torch.convert.torch_vgg import load_vgg_checkpoint

        return load_vgg_checkpoint(path, vgg_type=family)
    if family == "lpips":
        from vsr_tpu_torch.convert.torch_lpips import load_lpips_checkpoint

        return load_lpips_checkpoint(path)
    raise SystemExit(f"unknown family: {family}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vsr_tpu_torch.convert",
        description="Convert reference checkpoints to .npz",
    )
    ap.add_argument("family", choices=sorted(_DEFAULT_NAME))
    ap.add_argument("checkpoint")
    ap.add_argument("-o", "--output", default=None,
                    help="output .npz (default: ./<family-name>.npz)")
    args = ap.parse_args(argv)

    from vsr_tpu_torch.convert.params_io import save_params

    variables = _load(args.family, args.checkpoint)
    out = args.output or _DEFAULT_NAME[args.family]
    save_params(out, variables)
    size = os.path.getsize(out) / 1e6
    print(f"{args.family}: {args.checkpoint} -> {out} ({size:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
