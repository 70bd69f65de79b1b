"""Where the port's ProPainter band path spends device time, on an NVIDIA GPU.

    python3 scripts/propainter_breakdown.py      (from the repository root)

Prints, with the card's name and power limit:

* per-call device times of the path's samplers at its shapes: flow_warp
  (a gather per corner over H*W, every channel at one index) against the
  same four corners gathered as rows of C channels (the layout the port's
  first version used), and modulated_deform_conv at the feature-propagation
  and flow-completion shapes against its row-gather version;
* RAFT's window lookup on one pyramid level at 8 and 62 pair-directions;
* one 70-frame 1080p band clip (chip_smoke phase l's inputs and model), its
  window sweep split by module with CUDA events from forward hooks.

Needs one CUDA device; imports nothing of jax or vsr_tpu.
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from vsr_tpu_torch.masks.mask import create_mask  # noqa: E402
from vsr_tpu_torch.models.propainter.raft import _lookup_level  # noqa: E402
from vsr_tpu_torch.ops import grid_sample as gs  # noqa: E402
from vsr_tpu_torch.ops.deform_conv import modulated_deform_conv  # noqa: E402


def corners(h, w, coords):
    """The four bilinear corners' (weight, flat index), zero weight outside."""
    x0, y0 = torch.floor(coords[..., 0]), torch.floor(coords[..., 1])
    wx, wy = coords[..., 0] - x0, coords[..., 1] - y0
    for dx, dy, wt in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                       (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        xi, yi = x0 + dx, y0 + dy
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        yield wt * inb, (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()


def warp_rows(x, flow):
    """flow_warp with each corner gathered as rows of C channels."""
    B, C, H, W = x.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=x.device), torch.arange(W, device=x.device),
                            indexing="ij")
    coords = torch.stack([xs, ys], -1).float()[None] + flow.permute(0, 2, 3, 1).float()
    rows = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
    out = 0
    for wt, idx in corners(H, W, coords.reshape(B, -1, 2)):
        vals = torch.gather(rows, 1, idx[..., None].expand(-1, -1, C))
        out = out + vals * wt[..., None].to(x.dtype)
    return out.transpose(1, 2).reshape(B, C, H, W)


def deform_rows(x, offset, modulation, weight):
    """modulated_deform_conv with each corner gathered as rows of C/G channels."""
    B, C, H, W = x.shape
    G, K = offset.shape[1], 9
    cg = C // G
    dev = x.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(3, device=dev) - 1, torch.arange(3, device=dev) - 1,
                            indexing="ij")
    off = offset.permute(0, 4, 5, 2, 1, 3).float()
    px = (xs[:, :, None, None] + kx.reshape(-1)[:, None]).float() + off[..., 1]
    py = (ys[:, :, None, None] + ky.reshape(-1)[:, None]).float() + off[..., 0]
    rows = x.reshape(B, G, cg, H, W).permute(0, 3, 4, 1, 2).reshape(-1, cg)
    mod = modulation.permute(0, 3, 4, 2, 1).to(x.dtype)
    base = (torch.arange(B, device=dev) * H * W)[:, None, None, None, None]
    samples = 0
    for wt, idx in corners(H, W, torch.stack([px, py], -1)):
        idx = (idx + base) * G + torch.arange(G, device=dev)
        samples = samples + rows[idx.reshape(-1)].reshape(*idx.shape, cg) * (
            wt.to(x.dtype) * mod)[..., None]
    w_flat = weight.permute(2, 3, 1, 0).reshape(K * C, -1)
    return (samples.reshape(B * H * W, K * C) @ w_flat).reshape(B, H, W, -1).permute(0, 3, 1, 2)


def main() -> int:
    if not torch.cuda.is_available():
        print("propainter_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_a()
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    for name, C, h, w, dtype in (("image propagation frames", 3, 360, 1920, torch.float32),
                                 ("image propagation mask", 1, 360, 1920, torch.float32),
                                 ("image propagation flow", 2, 360, 1920, torch.float32),
                                 ("feature propagation flow", 2, 90, 480, torch.bfloat16),
                                 ("feature propagation features", 128, 90, 480, torch.bfloat16)):
        x = torch.randn((1, C, h, w), generator=g, device=dev).to(dtype)
        flow = (torch.randn((1, 2, h, w), generator=g, device=dev) * 20).to(dtype)
        print(f"flow_warp, {name} C={C} {h}x{w} {str(dtype)[6:]}: bilinear "
              f"{cs.cuda_ms(lambda: gs.flow_warp(x, flow), 10):.3f} ms, nearest "
              f"{cs.cuda_ms(lambda: gs.flow_warp(x, flow, 'nearest'), 10):.3f} ms; bilinear with "
              f"row gathers {cs.cuda_ms(lambda: warp_rows(x, flow), 10):.3f} ms on {card}")
    for name, B, C, h, w in (("feature propagation", 1, 128, 90, 480),
                             ("flow completion", 2, 256, 45, 240)):
        x = torch.randn((B, C, h, w), generator=g, device=dev).to(torch.bfloat16)
        off = torch.randn((B, 16, 9, 2, h, w), generator=g, device=dev) * 3
        mod = torch.rand((B, 16, 9, h, w), generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn((C if B == 1 else C // 2, C, 3, 3), generator=g, device=dev)
              * 0.05).to(torch.bfloat16)
        print(f"modulated_deform_conv, {name} x {tuple(x.shape)} bf16, 16 groups: "
              f"{cs.cuda_ms(lambda: modulated_deform_conv(x, off, mod, wt), 10):.3f} ms; with row "
              f"gathers {cs.cuda_ms(lambda: deform_rows(x, off, mod, wt), 10):.3f} ms on {card}")
    for n_pairs in (8, 62):
        n = n_pairs * 10800
        corr = torch.empty((n, 45, 240), device=dev).normal_(generator=g)
        cx = torch.rand((n,), generator=g, device=dev) * 280 - 20
        cy = torch.rand((n,), generator=g, device=dev) * 60 - 8
        print(f"RAFT lookup, level 0 (45x240), {n_pairs} pair-directions, radius 4: "
              f"{cs.cuda_ms(lambda: _lookup_level(corr, cx, cy, 4), 5):.3f} ms on {card}")
        del corr

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as phase l runs it
    inp = cs.propainter_inpainter("bfloat16")
    frames = cs.synthetic_video(cs.PP_FRAMES)
    mask = create_mask((cs.H, cs.W), [(300, 1620, 960, 1040)])
    inp(frames, mask)  # warm
    gen, events = inp.generator, {}

    def hook(module, label):
        def pre(*_):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            events.setdefault(label, []).append([start])

        def post(*_):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events[label][-1].append(end)

        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)

    hook(gen.encoder, "encoder")
    hook(gen.feat_prop_module, "feature propagation")
    for sweep in ("backward_sweep", "forward_sweep"):
        hook(getattr(gen.feat_prop_module, sweep).align, "  of it: deformable alignment")
    hook(gen.ss, "soft split")
    for i in range(gen.depths):
        hook(getattr(gen, f"block{i}").attention, "sparse window attention (8 blocks)")
        hook(getattr(gen, f"block{i}").mlp, "fusion feed-forward (8 blocks)")
    hook(gen.sc, "soft comp")
    _, dt = cs.timed(lambda: inp(frames, mask))
    print(f"one {cs.PP_FRAMES}-frame band clip: {dt:.3f} s wall on {card}; the generator by module "
          "(CUDA events from forward hooks):")
    for label, pairs in events.items():
        print(f"  {label}: {sum(s.elapsed_time(e) for s, e in pairs):.1f} ms over "
              f"{len(pairs)} calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
