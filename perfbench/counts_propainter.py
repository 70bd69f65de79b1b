"""ProPainter's model FLOPs of a clip, from shapes alone: the plain reference
(``reference/propainter.py``) run on the meta device under
``torch.utils.flop_counter.FlopCounterMode``, which counts convolutions and
matmuls (a multiply-add is two operations) and nothing else: the
correlation lookups, the warps, image propagation, softmax, folds and
activations count nothing.

What is counted is the published schedule's work on a T-frame clip of
h x w bands:

* RAFT: both encoders once a frame; for each consecutive pair, both
  directions: the all-pairs correlation and ``iters`` update steps, and the
  convex upsampling;
* flow completion: both directions of every sub-video of the tool's
  schedule, halo included;
* the generator: its encoder once a frame, then every window of the
  sweep (feature propagation with its deformable alignment, the soft
  split, the transformer blocks, the soft composition of the local frames
  and the decoder), with every attention window running the masked
  (spatio-temporal) branch, whatever the mask: a window the program
  skips still counts as work, so skipping shows as a higher MFU.

Frames encoded once is a choice of the count: upstream's RAFT re-encodes
both images of every pair in both directions, and its generator re-encodes
every window's frames; that repeated work is not counted.
"""

from __future__ import annotations

import functools
import json
from unittest import mock
from typing import Iterable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import propainter as ref


def _shape_of_sample(img: torch.Tensor, grid: torch.Tensor, **kwargs) -> torch.Tensor:
    """What F.grid_sample returns, by shape alone (its meta kernel is a slow
    decomposition, and a sample counts nothing)."""
    return img.new_empty((img.shape[0], img.shape[1], *grid.shape[1:-1]))


def _counted(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter, mock.patch.object(ref, "grid_sample", _shape_of_sample):
        fn()
    return counter.get_total_flops()


@functools.lru_cache(maxsize=16)
def _clip_flops(cfg_json: str, T: int, h: int, w: int) -> int:
    """Counted piece by piece, each piece once: a frame's encodings, one
    pair's correlation and one update step, the flow-completion net at two
    lengths (its work is linear in the length: every layer works frame by
    frame, each sweep step after the first aligns once), each distinct
    window shape of the sweep."""
    cfg = json.loads(cfg_json)
    meta = torch.device("meta")
    with meta:
        model = ref.ProPainter(cfg).eval()
    model = model.to(meta)
    q, r = model.q, cfg["raft"]

    def zeros(*shape):
        return torch.zeros(shape, device=meta)

    with torch.no_grad():
        # RAFT: encoders a frame; a pair's two directions: correlation, steps
        fh, fw = h // 8, w // 8
        total = T * _counted(lambda: model.raft.encode(zeros(1, 3, h, w), q))
        corr = _counted(lambda: ref.CorrBlock(zeros(2, 256, fh, fw), zeros(2, 256, fh, fw),
                                              r["corr_levels"], r["corr_radius"], q))
        planes = r["corr_levels"] * (2 * r["corr_radius"] + 1) ** 2
        step = _counted(lambda: model.raft.update_block(
            zeros(2, r["hidden"], fh, fw), zeros(2, r["context"], fh, fw),
            zeros(2, planes, fh, fw), zeros(2, 2, fh, fw), q))
        total += (T - 1) * (corr + r["iters"] * step)

        # flow completion, both directions of each sub-video
        def completion(t):
            flows = (zeros(1, t, 2, h, w),) * 2
            return _counted(lambda: model.flow_net.forward_bidirect_flow(
                flows, zeros(1, t + 1, 1, h, w), q))

        at2, at3 = completion(2), completion(3)
        n, sub = T - 1, cfg["subvideo_length"]
        lengths = [e - s for s, e, _, _ in ref._halo(n, sub, 5)] if n > sub else [n]
        total += sum(at2 + (t - 2) * (at3 - at2) for t in lengths)

        # the generator: its encoder a frame, then every window
        gen = model.generator
        total += T * _counted(lambda: gen.encode(zeros(1, 1, 3, h, w), zeros(1, 1, 1, h, w),
                                                 zeros(1, 1, 1, h, w), q))
        c = cfg["generator"]["channel"]
        shapes: dict = {}
        for nbrs, refs in ref.clip_windows(T, cfg):
            key = (len(nbrs) + len(refs), len(nbrs))
            shapes[key] = shapes.get(key, 0) + 1
        for (t, lt), count in shapes.items():
            flows = (zeros(1, lt - 1, 2, h, w),) * 2
            masks = zeros(1, t, 1, h, w)
            total += count * _counted(lambda: gen.forward_encoded(
                zeros(t, c, h // 4, w // 4), flows, masks, masks, lt, q, dense=True))
    return int(total)


def clip_flops(cfg: dict, T: int, h: int, w: int) -> int:
    """Model FLOPs of one T-frame clip of h x w bands (see the module's
    docstring)."""
    return _clip_flops(json.dumps(cfg, sort_keys=True), T, h, w)


def model_flops(cfg: dict, work: Iterable[Tuple[int, int, int]]) -> int:
    """The clips ``work`` (each (frames, band height, band width), a
    driver's ``chunk_work``)."""
    return sum(clip_flops(cfg, T, h, w) for T, h, w in work)
