"""Planted faults against chip_smoke.py's bf16 token-attention checks.

    python3 kernel_faults.py

Needs one NVIDIA Hopper GPU and nvcc. Builds csrc/token_attention.cu as it
is (the control) and once for each fault below, planted in a copy of the
source in a temporary directory, and runs each build on phase b's inputs of
chip_smoke.py: the two sttn-auto kernel scales, bf16, some keys masked and
every key masked. For each case it prints max |err|, ||err|| / ||ref|| and
which of chip_smoke.compare's checks fail. The faults sit in the p v
kernel's merge of the score tiles' partial sums, where a wrong factor on one
key tile moves each output by a few 1e-3. Exits non-zero if the control
fails a check or a fault passes every check.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import torch

import chip_smoke
from vsr_tpu_torch.ops import _build
from vsr_tpu_torch.ops import token_attention as ta

SOURCE = os.path.join(_build.CSRC, "token_attention.cu")
_F0 = "exp2f(part_m[r0 + (size_t)k * nq_pad] - m[0])"
_F1 = "exp2f(part_m[r0 + (size_t)k * nq_pad + 8] - m[1])"
# name -> (text of the source, its replacement); each text occurs once
FAULTS = {
    "control": [],
    "key tile 1's p zeroed": [
        (f"{_F0} * inv_l[0];", f"{_F0} * inv_l[0] * (k == 1 ? 0.f : 1.f);"),
        (f"{_F1} * inv_l[1];", f"{_F1} * inv_l[1] * (k == 1 ? 0.f : 1.f);"),
    ],
    "key tile 1's rescale 2^(m_t - m) left out": [
        (f"{_F0} * inv_l[0];", f"(k == 1 ? 1.f : {_F0}) * inv_l[0];"),
        (f"{_F1} * inv_l[1];", f"(k == 1 ? 1.f : {_F1}) * inv_l[1];"),
    ],
}


def use_source(root: str, edits) -> None:
    """Point the kernel build at a copy of SOURCE under root with edits made."""
    csrc = os.path.join(root, "csrc")
    os.makedirs(csrc)
    with open(SOURCE) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} occurs {src.count(old)} times in {SOURCE}")
        src = src.replace(old, new)
    with open(os.path.join(csrc, "token_attention.cu"), "w") as f:
        f.write(src)
    _build.CSRC, _build.BUILD_DIR = csrc, os.path.join(root, "build")
    _build.LIB_PATH = os.path.join(_build.BUILD_DIR, "libvsr_torch_kernels.so")
    _build._lib = None
    ta._tiles.cache_clear()


def cases():
    """Phase b's bf16 inputs of chip_smoke.py, drawn in the same order."""
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for scale, (B, N, D) in chip_smoke.SCALES.items():
        q, k, v = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(3))
        some = torch.where(torch.rand((B, N), generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0).float()
        every = torch.full((B, N), -1e9, device="cuda")
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        for bias_name, bias in (("some keys masked", some), ("every key masked", every)):
            yield f"{scale} {bias_name}", q, k, v, bias


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_faults: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.phase_a()  # prints the card's name and power limit
    refs = {name: ta.token_attention_reference(q, k, v, bias)
            for name, q, k, v, bias in cases()}
    bad = []
    root = tempfile.mkdtemp(prefix="kernel_faults_")
    try:
        for i, (fault, edits) in enumerate(FAULTS.items()):
            use_source(os.path.join(root, str(i)), edits)
            _build.get_lib()
            caught = False
            for name, q, k, v, bias in cases():
                max_err, rel, failed = chip_smoke.compare(
                    ta.flash_token_attention(q, k, v, bias), refs[name])
                caught |= bool(failed)
                print(f"{fault}: {name}: max |err| {max_err:.3e}, ||err||/||ref|| "
                      f"{rel:.3e}, fails: {', '.join(failed) or 'nothing'}", flush=True)
            if caught != (fault != "control"):
                bad.append(fault)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if bad:
        print(f"kernel_faults: wrong verdict for {bad}", file=sys.stderr)
        return 1
    print("kernel_faults: the control passes, every planted fault is caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
