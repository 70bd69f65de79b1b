"""chip_smoke's phase q alone: the sttn-auto window engine, a LaMa band
batch and a ProPainter band clip split over a mesh of every visible card
(and over two replicas on cuda:0), each against one device.

    python3 scripts/mesh_cards.py      (from the repository root)

On a machine with two or more cards this is the only run of the mesh's
cross-card copies; with one card it runs the two-replica mesh alone. It
builds the kernels (phase a) first, prints each phase's log lines and then
one JSON object with the card's name and power limit. Imports nothing of
jax or vsr_tpu.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from vsr_tpu_torch.masks.mask import create_mask

    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_a()
    frames = cs.synthetic_video(cs.N_FRAMES)
    mask = create_mask((cs.H, cs.W), [(300, 1620, 960, 1040)])  # chip_smoke's band
    print(json.dumps({"card": card, "mesh": cs.phase_q(card, frames, mask)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
