"""On-card smoke test of the PyTorch/CUDA port (vsr_tpu_torch), at full width.

    python3 chip_smoke.py [--profile]

Needs one NVIDIA Hopper GPU, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and
g++. Phases, each of which raises on failure (the script then exits
non-zero and prints no result line):

  (a) card and build: the card's name and power limit from nvidia-smi, then
      the CUDA kernels built from vsr_tpu_torch/csrc with nvcc for sm_90a
      and ptxas's register, spill and wgmma notes;
  (b) kernel against plain version: flash_token_attention against
      token_attention_reference at the sttn-auto scales (5,3) (N=5120,
      D=960) and (10,5) (N=1536, D=3200), fp32 (TF32 off) and bf16, with a
      bias masking some keys and one masking every key; max error and, in
      bf16, the error's norm against the output's, each held to a limit
      below (kernel_faults.py shows the norm check catching faults that
      the element-wise one misses); each side's time, the bound (the larger
      of the operations over the peak rate and the bytes of q, k, v, bias
      and out over the memory rate; the operations are 4 N^2 D in bf16 and
      3 x 4 N^2 D at the TF32 rate in fp32, the kernel's 3xTF32, with 4 N^2
      D at the fp32 FMA rate printed beside it), the device time of each
      CUDA kernel of a call, and the time of torch's
      scaled_dot_product_attention with the same float mask (library_ms,
      the yardstick; the port never calls it) with the backend that served
      it;
  (c) the main path: STTNAutoInpainter.process_video in bf16 on 100
      synthetic 1920x1080 frames (2 chunks of 50) under the bottom-band
      subtitle mask, full model width, seeded random weights, MAIN_RUNS timed
      runs after a warm one; frames in == frames out, pixels outside the
      mask bit-identical, pixels inside changed, kernel launches == 2
      scales x 8 blocks x windows x chunks in every run; frames/s. With
      --profile, a torch.profiler table of one more run goes to
      chiprun_out/chip_smoke_profile.txt, and the host time of another is
      split by step (as for phase f, into chip_smoke_profile_sttn_det.txt);
  (d) kernel route against plain route: one 50-frame chunk through the
      kernel and again with the model's token attention routed to
      token_attention_reference, in fp32 (max uint8 difference <= 2) and in
      bf16 (max and mean uint8 difference inside the mask, limits below);
      then the fp32 main path: process_video on (c)'s 100 frames through the
      kernel, TF32 off, one warm and MAIN_RUNS timed runs checked as in (c)
      (fps_1080p_fp32);
  (e) detection at full width: a synthetic 100-frame 1920x1080 30 fps mp4
      (written with cv2, subtitle text on frames 11-40 and 61-70) through
      SubtitleDetector.find_subtitle_frame_no (PP-OCRv5 server DBNet,
      seeded random weights, fp32 with cuDNN's TF32 off, as the detector
      runs it), timed after a warm call; one frame's probability map
      against the same weights on the CPU in fp32 (max |err| <= DET_TOL),
      and, for the record only, with TF32 on; the boxes found;
  (f) the sttn-det main path: STTNDetInpainter.__call__ in bf16 on the 100
      frames of (c) under the same mask, MAIN_RUNS timed runs after a warm one
      (frames in == frames out, outside the mask bit-identical, inside
      changed, kernel launches == 8 blocks x windows x chunks, all at the
      (9,5) scale); then SubtitleRemover(..., device="cuda").run() in
      sttn-det mode on the mp4, with the detector replaced by a fixed
      frame -> boxes map (random DBNet weights find no real text; (e) ran
      the real one), launches counted the same way, frames and size of the
      output checked;
  (g) the det route check: one 50-frame chunk through STTNDetInpainter with
      the kernel and with token_attention_reference, fp32 within 2 uint8,
      bf16 within phase d's max and mean limits;
  (h) the LaMa band path: LamaInpainter.__call__ in bf16 on the 100 frames
      of (c) under the same mask, big-lama at full width (ngf 64, 18 FFC
      blocks) with seeded random weights, one warm run and MAIN_RUNS timed
      runs (frames in == frames out, outside the mask bit-identical,
      inside changed, no hand kernel launched: the path is cuDNN + cuFFT);
      the band geometry, frames/s, one band batch's device time and its
      convolutions' TFLOP (forward hooks) against the bf16 peak. With
      --profile, a torch.profiler table in
      chiprun_out/chip_smoke_profile_lama.txt and the host time split into
      crop + staging, H2D, forward dispatch, fetch and paste;
  (i) LaMa on the card against the CPU: the full-width generator on one
      256x512 input, card fp32 (TF32 off) against CPU fp32 on the same
      weights, max |err| <= LAMA_CPU_TOL on the sigmoid output; then one
      band batch of (h) in bf16 against fp32 on the card, uint8 inside the
      mask within the limits below;
  (j) picture mode: SubtitleRemover(png, device="cuda").run() on frame 15
      of (e)'s mp4 saved as a 1920x1080 PNG, the detector replaced by a
      fixed box, once cold (the remover builds its LaMa) and once warm;
      the file is written at the same size and changed inside the mask;
  (k) the mobile detector: (e) again with subtitle_detect_mode
      PP_OCRv5_MOBILE (PP-LCNetV3 0.75 + RSEFPN 96 + the small head), its
      random weights tamed (see LCNET_BRANCH_SCALE).

  (l) the ProPainter band path: PropainterInpainter.__call__ in bf16 (RAFT
      in fp32, cuDNN's TF32 at PyTorch's default, on) on the first 70
      frames of (c) (one propainter_max_load_num batch) under the same
      mask, full model width (generator channel 128, hidden 512, 8 blocks,
      4 heads, window (5,9), pool (4,4); RAFT 20 iterations, 4 levels,
      radius 4), seeded random weights; one warm run and two timed runs
      (frames in == frames out, outside the dilated mask bit-identical,
      inside changed, no hand kernel launched: the path has none); the band
      geometry, frames/s, each stage's device time (CUDA events around
      flows, completion, image propagation, encode, window sweep), each
      stage's FLOPs (torch's FlopCounterMode on the meta device, the same
      code at the same shapes) and peak memory. With --profile, a
      torch.profiler table in chiprun_out/chip_smoke_profile_propainter.txt;
  (m) ProPainter on the card against the CPU, fp32 with TF32 off, same
      weights: RAFT on one 128x256 pair (flow within PP_FLOW_TOL px);
      raft_bi_flows on a 4-frame 128x256 crop of the noise clip against
      RAFT.forward on each pair on the card and against raft_bi_flows on
      the CPU (each within PP_FLOW_TOL px; beside them the same per-pair
      comparison on the CPU, a second call, and the encoder's batch of 4
      against each frame alone); the
      full-width generator's encode + forward_encoded on one small window
      (within PP_GEN_TOL); then one full-width band window through the
      generator in bf16 against fp32 on the card, from the same fp32 flows
      and propagated frames, uint8 inside the hole within the limits below;
  (n) propainter mode end to end: SubtitleRemover(mp4, device="cuda").run()
      on (e)'s mp4 with the fixed frame -> boxes map of (f) plus frame 80
      alone: scene detection, the 30- and 10-frame ranges through
      ProPainter, frame 80 through LaMa; the output's frames and size;
  (o) the model bootstrap: a reference-format models tree written at full
      width from seeded numpy (reference_specs: sttn-auto/infer_model.pth
      and sttn-det/sttn.pth as {"netG": ...}, big-lama/big-lama.pt as a raw
      state dict cut into filesplit parts with an fs_manifest.csv,
      propainter/raft-things.pth with 'module.' prefixes,
      recurrent_flow_completion.pth and ProPainter.pth; no V5/, so both
      DBNet families are missing); `python -m vsr_tpu_torch
      --prepare-models TREE --models OUT` in a subprocess (rc 0, 6 families
      converted, 2 missing, its wall seconds); each .npz loaded strict into
      the port's module and held bit for bit against the .pth route
      (load_*_weights on the reference file; for LaMa, the merged file
      mapped by convert/torch_lama.py and from_flax); `python -m
      vsr_tpu_torch --warmup --warmup-sizes 1080 1920 --models OUT --device
      cuda` in a fresh subprocess (rc 0, a ready line for sttn-auto,
      sttn-det and lama; each mode's and each build's seconds); then
      SubtitleRemover(e's mp4, checkpoint_dir=OUT, device="cuda").run() in
      sttn-auto mode (frames and size of the output, token-attention
      launches as (c) counts them) and the same run with its inpainter
      loaded from infer_model.pth: the two outputs' frames bit-identical;
  (p) the GUI and the batch queue with workers on the card: GuiServer(port=0,
      device="cuda") in this process, VSR_TPU_MODELS at (o)'s prepared
      weights; over HTTP with the session token, three tasks: (e)'s mp4 in
      sttn-auto with SUB_AREA, frame PICTURE_FRAME as a 1920x1080 PNG
      (locked to LaMa; the random DBNet finds no text, so the picture is
      written unchanged), and a copy of the mp4 stopped through /api/stop
      once its progress passes GUI_STOP_AT %; /api/state polled until all
      are done: completed, completed, failed with "stopped", a decodable
      side-by-side preview JPEG, every worker's first log line naming the
      card, the stopped worker's pid gone from nvidia-smi's compute
      processes and the card's memory used back within
      GUI_MEMORY_SLACK_MIB of what it was before the queue (nvidia-smi may
      list no pid of a container's processes); per task the
      wall time from processing to done, the worker's own processing time
      (its "processing time:" line) and their difference, the start-up;
      then the same video through SubtitleRemover.run() in this process
      (uint8 max and mean difference against the worker's output, max <=
      MAX_U8_DIFF) and TaskRunner(device="cuda") on the PNG;
  (q) the inpainters' mesh: a 50-frame sttn-auto chunk through
      STTNWindowEngine (bf16, full width, window batch 1), a LaMa band batch
      of 16 and a 20-frame ProPainter band clip, each alone and with mesh
      [cuda:0, cuda:0] (two replicas on one card), and over every card when
      there are two or more: split against single device max <= 1 uint8 and
      <= 1% of values differing (LaMa 5%), the STTN run's kernel launches
      equal to the single device's (16 a window batch, padded windows
      included when the cards do not divide the windows), times of both.
  (r) training on the card, fp32 with cuDNN's and matmul's TF32 off, data
      from SEED (uniform frames, the training set's random moving masks,
      smooth random flows), every module seeded: (r1) STTNTrainer at
      TrainConfig() defaults (sttn-auto 640x120, channel 256, 8 blocks,
      batch 8 of 5 frames, discriminator nf 64, hinge; halved on an
      out-of-memory error), one warm and three timed steps (CUDA events),
      frames/s (B*L over the step), peak memory, finite losses, the
      generator moved; then save, restore into a fresh trainer and step
      both with cudnn.deterministic: losses within RESUME_RTOL; (r2) two
      steps at channel 64, 2 blocks, nf 16 on the card and on the CPU from
      one init: losses within TRAIN_CPU_RTOL, the largest parameter
      difference printed; (r3) FlowCompletionTrainer, two timed steps of 10
      frames at PP_TRAIN_HW; (r4) PropainterTrainer at full width (channel
      128, hidden 512, 8 blocks, nf 32) with the LPIPS term on a random
      vgg16, 10 local + 6 reference frames at PP_TRAIN_HW, two timed steps
      and peak memory. The token-attention kernel launches 0 times in
      phase r (trainers use the plain route: the kernel is forward-only),
      and calling it on inputs that require grad raises (F6).
  (s) training across processes, I3D and VFID, the flow losses (fp32,
      TF32 off): one process first runs each check's reference on the card,
      then two ranks spawned on cuda:0 join a gloo world through
      init_distributed ("cuda:0", torchrun's variables set) and run (s1)
      STTNTrainer at TrainConfig() defaults over a data group of 2 (the
      global batch 8 of 5 frames, 4 a rank; the same seeded batches with
      the training set's moving masks, every sample its own; a warm and two
      timed steps, each restored to the one process's state before it),
      (s2) one full-width STTN step over data 1 x model 2 at global batch
      TP_BATCH (the generator's convolutions split over the model group;
      at least one must be), and (s3) one FlowCompletionTrainer
      and one PropainterTrainer step (full width, global batch 2 at
      PP_TRAIN_HW); every rank's losses within TRAIN_CPU_RTOL of one
      process's, the largest parameter difference, step times (host clock
      around a synchronised step) and each rank's peak memory printed; with
      two or more cards s1 again over NCCL, one rank a card; then `torchrun
      --nproc_per_node=1 -m vsr_tpu_torch.train.train_sttn --distributed
      --steps 2` on two synthetic frame directories (NCCL, rc 0 and
      ckpt_2.pt written); (s4) a full-width random i3d_rgb_imagenet.pt
      through `python -m vsr_tpu_torch.convert i3d` and from_flax, loaded
      strict (equal to the .pt loaded strict), features of I3D_CLIPS clips
      of 16x224x224 on the card against the CPU (max |err| <= I3D_CPU_TOL),
      the VFID of VFID_CLIPS clips against noisy copies and clips/s; (s5)
      the four flow losses on the card against the CPU. The token-attention
      kernel launches 0 times in phase s, in this process and in every rank.

Phase b also runs the kernel at STTN-det's (9,5) scale (N = 2304, and 1728
for a short range's chunk; D = 2880) with, besides the two biases above,
the det variant's patch gating on top of padded frames.

Phases h-j tame LaMa's random weights (see tame_lama). The line before
last is a JSON summary of the kernels and of each path; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch import nn

W, H = 1920, 1080
N_FRAMES = 100  # two chunks of clip_gap = 50
# timed runs of phases c, f and h: two since phases l-n took the script past
# ten minutes (three until then)
MAIN_RUNS = 2
SEED = 0
F32_TOL, BF16_TOL = 2e-5, 2e-2  # |err| <= tol * (1 + |ref|), as tests/test_pallas_attention.py
# bf16 also: ||got - ref|| / ||ref|| <= BF16_REL. The element-wise bound above
# is about as large as a typical output here (~0.014 to 0.05 with randn
# inputs, N = 1536 to 5120 keys), so a fault in one key tile's rescale in the
# merge of the tiles' partial sums moves the outputs by a few 1e-3 and slips
# under it. The norm of the error sees such a fault; a correct kernel stays
# near bf16's rounding of its output (PERF.md has both).
BF16_REL = 1e-2
SCALES = {"(5,3)": (1, 5120, 960), "(10,5)": (1, 1536, 3200)}  # sttn-auto
# sttn-det: N = L * 144 with L = 16 (a 50-frame chunk) and L = 12 (a chunk of
# 20 frames or fewer); 1728 is no multiple of the 256-row score tile
DET_SCALES = {"(9,5)": (1, 2304, 2880), "(9,5) N=1728": (1, 1728, 2880)}
# the detector's probability map on the card (fp32, TF32 off) against the
# CPU: the repo's activation-parity bound (ROADMAP.md), which the card's
# other summation order should stay far inside
DET_TOL = 1e-3
DET_FPS = 30
SUB_FRAMES = {range(11, 41): (560, 1360, 950, 1010), range(61, 71): (640, 1280, 940, 1000)}
MAX_U8_DIFF = 2  # fp32: kernel route against plain route
# bf16, inside the mask: the kernel rounds p to bf16 before p v, the plain
# route does not, and 8 blocks of bf16 activations carry the difference to
# the decoder. Measured on an H100 (PERF.md), max / mean: 4 / 0.109 with the
# previous mma.sync kernel of the same contract, 4 / 0.109 with this one.
# Twice the max and ~5x the mean leave room for other seeds and cards and
# still catch a wrong kernel (which moves the mean by tens of uint8).
BF16_MAX_U8_DIFF, BF16_MEAN_U8_DIFF = 8, 0.5
# NVIDIA's data sheet for the H100 SXM, dense: bf16 and TF32 on the tensor
# cores, fp32 outside them, and the HBM3 rate
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
# fp32-accurate products on the tensor cores take three tf32 products each
# (3xTF32: lo hi + hi lo + hi hi of split operands), the kernel's fp32 route
TF32_PASSES = 3
MEM_BYTES_PER_S = 3.35e12
OUT_DIR = "chiprun_out"
# LaMa: the card's fp32 (TF32 off) sigmoid output against the CPU's, the
# repo's activation-parity bound (ROADMAP.md)
LAMA_CPU_TOL = 1e-3
# one band batch in bf16 against fp32 on the card, uint8 inside the mask:
# measured max 1, mean 0.084 on an H100 at 700 W (PERF.md); 4x the max and ~6x
# the mean leave room for other cards and still catch a wrong layer (which
# moves the mean by tens of uint8)
LAMA_BF16_MAX_U8, LAMA_BF16_MEAN_U8 = 4, 0.5
# random big-lama weights grow the 18 blocks' residual stream to std ~440
# and saturate the sigmoid (96% of outputs at 0 or 1, measured on the CPU at
# 256x512); each block's second BatchNorm scaled by this keeps it near 1
LAMA_RESIDUAL_SCALE = 0.3
PICTURE_FRAME = 15  # a frame of the mp4 with a subtitle line
PP_FRAMES = 70  # one propainter_max_load_num batch
PP_RUNS = 2
# ProPainter on the card (fp32, TF32 off) against the CPU: RAFT's flow in
# pixels, and the generator's tanh output, the repo's activation-parity
# bound (ROADMAP.md). The flow bound also holds raft_bi_flows to
# RAFT.forward on each pair on the card: on an H100 the batches of 6 pairs
# and of 1 differ by 7.63e-5 px on flows of up to ~115 px (one fp32 ulp
# there is 7.6e-6), where the CPU gives the two bit for bit (PERF.md); a
# pair formed across clips or in the wrong direction is off by pixels
PP_FLOW_TOL, PP_GEN_TOL = 1e-3, 1e-3
# one band window through the generator, bf16 against fp32 on the card,
# uint8 inside the hole: measured max 7, mean 0.589 on an H100 at 700 W
# (PERF.md); 4x the max and ~5x the mean, as for LaMa
PP_BF16_MAX_U8, PP_BF16_MEAN_U8 = 28, 3.0
PP_STAGES = {"_compute_flows": "flows", "_complete_flows": "completion",
             "_propagate_images": "image propagation", "_encode_clip": "encode",
             "_sweep_windows": "window sweep"}
# random PP-LCNetV3 weights sum five or six unit-scale branches a layer and
# grow the backbone's activations to ~1e4: the map is noise (94% of it over
# the 0.3 threshold), and post-processing its contours took 240 ms a frame
# on the card's host. Each branch's BatchNorm scaled by this keeps them
# near 1, as tests/test_torch_detect.py does.
LCNET_BRANCH_SCALE = 0.4


def log(msg: str) -> None:
    print(msg, flush=True)


class ListReader:
    """read() -> (ok, frame) over an in-memory list; hands out copies."""

    def __init__(self, frames):
        self._frames, self._i = frames, 0

    def read(self):
        if self._i >= len(self._frames):
            return False, None
        self._i += 1
        return True, self._frames[self._i - 1].copy()


class ListWriter:
    def __init__(self):
        self.frames = []

    def write(self, frame):
        self.frames.append(frame)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters back-to-back launches (after one
    warm call). The card first spins for a few ms, so that every launch is
    queued before it starts and host gaps between calls are not counted."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time to enqueue fn() (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / iters


def bound_ms(B: int, N: int, D: int, dtype: str):
    """Least time the card could take for one call, and what sets it. fp32
    work is held to fp32 accuracy on the tensor cores: 3 x 4 N^2 D at the
    TF32 rate, which is less time than 4 N^2 D at the FMA rate (fma_bound_ms)."""
    flops = 4.0 * B * N * N * D
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 4.0 * B * N * D * elem + 4.0 * B * N  # q, k, v read, out written; fp32 bias
    t_ops = (flops / PEAK_FLOPS["bfloat16"] if dtype == "bfloat16"
             else TF32_PASSES * flops / PEAK_FLOPS["tf32"])
    t_bytes = nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fma_bound_ms(B: int, N: int, D: int) -> float:
    """4 N^2 D at the fp32 FMA rate: the bound before the route used the
    tensor cores, printed for comparison."""
    return 1e3 * 4.0 * B * N * N * D / PEAK_FLOPS["float32"]


def compare(got, ref):
    """max |got - ref|, ||got - ref|| / ||ref||, and the checks that failed:
    finite values, within tol * (1 + |ref|) element-wise, and in bf16 within
    BF16_REL in norm."""
    bf16 = got.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        return float("nan"), float("nan"), ["non-finite output"]
    err = (got - ref).abs()
    rel = ((got - ref).norm() / ref.norm()).item()
    tol = BF16_TOL if bf16 else F32_TOL
    failed = []
    if (err - tol * (1 + ref.abs())).max().item() > 0:
        failed.append(f"|err| over {tol:g}*(1+|ref|)")
    if bf16 and rel > BF16_REL:
        failed.append(f"||err||/||ref|| over {BF16_REL:g}")
    return err.max().item(), rel, failed


def library_call(q, k, v, bias):
    """torch's scaled_dot_product_attention with the same float mask and
    1/sqrt(D) scale, on the first backend that takes these shapes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    mask = bias[:, None, None, :].to(q.dtype)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return sdpa(q[:, None], k[:, None], v[:, None], attn_mask=mask)[:, 0]
        try:
            out = call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, call, out
    raise RuntimeError("no scaled_dot_product_attention backend took these inputs")


def device_split(fn, iters: int = 10):
    """Mean device time of each CUDA kernel fn() runs (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    def short(key):  # a kernel's own name: the identifier before its template or arguments
        m = re.search(r"(\w+)(?:<[^(]*>)?\(", key)
        return m.group(1) if m else key

    return {short(e.key): e.device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def phase_a():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    from vsr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.get_lib()
    log(f"[a] built {_build.LIB_PATH} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "wgmma", "setmaxnreg")):
            log(f"[a] ptxas: {line.strip()}")
    return card


def phase_b(card):
    from vsr_tpu_torch.ops.token_attention import (
        flash_token_attention, token_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, []
    for scale, (B, N, D) in {**SCALES, **DET_SCALES}.items():
        q, k, v = (torch.randn((B, N, D), generator=gen, device="cuda") for _ in range(3))
        some = torch.where(torch.rand((B, N), generator=gen, device="cuda") < 0.3,
                           -1e9, 0.0).float()
        every = torch.full((B, N), -1e9, device="cuda")
        biases = [("some keys masked", some), ("every key masked", every)]
        if scale in DET_SCALES:
            biases.append(("patch gating", det_bias(B, N // 144).cuda()))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
            for bias_name, bias in biases:
                got = flash_token_attention(qd, kd, vd, bias)
                ref = token_attention_reference(qd, kd, vd, bias)
                max_err, rel, failed = compare(got, ref)
                worst = max(worst, max_err)
                log(f"[b] {scale} B={B} N={N} D={D} {name} {bias_name}: "
                    f"max |err| {max_err:.3e}, ||err||/||ref|| {rel:.3e}")
                if failed:
                    raise AssertionError(f"[b] {scale} {dtype} {bias_name}: " + ", ".join(failed))
            backend, library, lib_out = library_call(qd, kd, vd, some)
            lib_err = (lib_out.float() - token_attention_reference(qd, kd, vd, some).float()
                       ).abs().max().item()
            kernel_ms = cuda_ms(lambda: flash_token_attention(qd, kd, vd, some), 10)
            plain_ms = cuda_ms(lambda: token_attention_reference(qd, kd, vd, some), 10)
            library_ms = cuda_ms(library, 10)
            bms, bound_by = bound_ms(B, N, D, name)
            split = device_split(lambda: flash_token_attention(qd, kd, vd, some))
            enqueue_ms = host_ms(lambda: flash_token_attention(qd, kd, vd, some), 10)
            fma = (f"; 4 N^2 D at the fp32 FMA rate {fma_bound_ms(B, N, D):.4f} ms"
                   if dtype == torch.float32 else "")
            log(f"[b] {scale} {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms (sdpa {backend}, max |err| {lib_err:.2e}), "
                f"bound {bms:.4f} ms ({bound_by}), kernel at {100 * bms / kernel_ms:.1f}% "
                f"of bound{fma}, on {card}")
            log(f"[b] {scale} {name}: device time by kernel (profiler) " +
                ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()) +
                f"; host time to enqueue a call {enqueue_ms:.4f} ms")
            cases.append({"scale": scale, "path": "sttn-det" if scale in DET_SCALES else "sttn-auto",
                          "N": N, "D": D, "dtype": name, "ms": kernel_ms, "plain_ms": plain_ms,
                          "bound_ms": bms, "bound_by": bound_by, "library_ms": library_ms,
                          "library_backend": backend})
    return worst, cases


def det_bias(B, L, padded=3):
    """The sttn-det (9,5) key bias as ops/patch_attention.py builds it: 144
    tokens (12 x 12) a frame, the last ``padded`` frames padded slots
    (-1e9), and the tokens whose patch lies mostly in a bottom-band hole
    (rows 7-9, columns 2-10 of the frame's grid) gated (-1e9): keys that
    are both carry -2e9."""
    gated = torch.zeros((12, 12), dtype=torch.bool)
    gated[7:10, 2:11] = True
    frame = torch.where(torch.arange(L) < L - padded, 0.0, -1e9)[:, None]
    bias = frame + torch.where(gated.reshape(-1), -1e9, 0.0)[None, :]
    return bias.reshape(1, -1).expand(B, -1).contiguous().float()


def synthetic_video(n):
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return [np.roll(base, 7 * i, axis=1) for i in range(n)]


def run_video(inpainter, frames, mask):
    writer = ListWriter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = inpainter.process_video(ListReader(frames), writer, mask, len(frames), (W, H))
    torch.cuda.synchronize()
    return n, writer.frames, time.perf_counter() - t0


def check_frames(frames, out, mask, phase="c"):
    inside = mask > 0
    changed = 0
    for src, got in zip(frames, out):
        if got.shape != src.shape or got.dtype != np.uint8:
            raise AssertionError(f"[{phase}] frame {got.shape} {got.dtype}, "
                                 f"expected {src.shape} uint8")
        if not np.array_equal(got[~inside], src[~inside]):
            raise AssertionError(f"[{phase}] pixels outside the mask changed")
        changed += int(np.any(got[inside] != src[inside]))
    if changed != len(frames):
        raise AssertionError(f"[{phase}] only {changed}/{len(frames)} frames changed "
                             "inside the mask")


def phase_c(card, frames, mask, profile):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.ops import token_attention

    cfg = Config(compute_dtype="bfloat16")
    inpainter = STTNAutoInpainter(config=cfg, device="cuda")
    clip = inpainter.clip_gap
    n, _, dt = run_video(inpainter, frames[:clip], mask)  # warm: cuDNN plans, allocator
    log(f"[c] warm pass: {n} frames in {dt:.2f} s")

    fps = []
    for run in range(MAIN_RUNS):
        token_attention.launches = 0
        n, out, dt = run_video(inpainter, frames, mask)
        launches = token_attention.launches
        engine = next(iter(inpainter._engines.values()))
        chunks = -(-len(frames) // clip)
        want = expected_auto_launches(inpainter, len(frames))
        log(f"[c] main path run {run + 1}: {n} frames, {chunks} chunks of {clip}, "
            f"{engine.num_windows} windows/chunk, kernel launches {launches} (expected {want})")
        if n != len(frames) or len(out) != len(frames):
            raise AssertionError(f"[c] wrote {n} frames ({len(out)} kept) of {len(frames)}")
        if launches != want or launches == 0:
            raise AssertionError(f"[c] kernel launches {launches}, expected {want}")
        check_frames(frames, out, mask)
        fps.append(n / dt)
        log(f"[c] sttn-auto 1080p bf16 run {run + 1}: {fps[-1]:.2f} frames/s "
            f"({dt:.3f} s for {n} frames) on {card}")
    if profile:
        from vsr_tpu_torch.inpaint import sttn_auto

        def run():
            return run_video(inpainter, frames, mask)

        profile_run(run, len(frames), card, "c", "chip_smoke_profile.txt")
        host_breakdown(run, len(frames), [
            (inpainter, "_stack_band", "crop + resize"), (sttn_auto, "paste_band", "paste"),
            *engine_targets(inpainter)], "c")
    return launches, fps


def expected_auto_launches(inpainter, n):
    """sttn-auto: 2 kernel scales x 8 blocks x windows per chunk x chunks."""
    engine = next(iter(inpainter._engines.values()))
    chunks = -(-n // inpainter.clip_gap)
    return 2 * len(inpainter.model.transformer) * engine.num_windows * chunks


def profile_run(run, n, card, phase, out_name):
    """Device time by kernel over one more n-frame run() (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, dt = timed(run)
    # device-side events only (kernels, memcpys, memsets): the CPU-side ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    events.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in events)
    lines = [f"{card}; torch.profiler over one run of {n} frames "
             f"(profiled wall {dt:.3f} s); device time {total / 1e3:.1f} ms"]
    for e in events:
        lines.append(f"{e.device_time_total / 1e3:10.2f} ms "
                     f"{100 * e.device_time_total / total:6.2f}% "
                     f"n={e.count:6d}  {e.key[:110]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:16]:
        log(f"[{phase}] profile: {line}")


def host_breakdown(run, n, targets, phase):
    """Host wall time of one more n-frame run(), split by the host steps in
    ``targets`` [(object, attribute, label)]: each is wrapped in a timer
    for the run; the rest is reported as other."""
    totals = {}

    def timed_step(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return wrapper

    saved = [(obj, attr, getattr(obj, attr), attr in vars(obj)) for obj, attr, _ in targets]
    for obj, attr, name in targets:
        setattr(obj, attr, timed_step(name, getattr(obj, attr)))
    try:
        _, dt = timed(run)
    finally:
        for obj, attr, fn, own in saved:
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)  # back to the class's method
    rest = dt - sum(totals.values())
    log(f"[{phase}] host time of {n} frames, {dt:.3f} s: " +
        ", ".join(f"{k} {v:.3f} s" for k, v in totals.items()) +
        f", other {rest:.3f} s")


def engine_targets(inpainter):
    out = []
    for engine in inpainter._engines.values():
        out += [(engine, "dispatch", "dispatch"), (engine, "fetch", "fetch (device wait + D2H)")]
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def routes_u8_diff(phase, dtype, run, mask):
    """run() -> one chunk's output frames, once through the kernel and once
    with the model's token attention routed to its plain version."""
    from vsr_tpu_torch.ops import patch_attention, token_attention

    before = token_attention.launches
    kernel_out, dt_kernel = timed(run)
    if token_attention.launches == before:
        raise AssertionError(f"[{phase}] kernel route launched no kernel")
    patch_attention.flash_token_attention = token_attention.token_attention_reference
    try:
        before = token_attention.launches
        plain_out, dt_plain = timed(run)
        if token_attention.launches != before:
            raise AssertionError(f"[{phase}] plain route launched the kernel")
    finally:
        patch_attention.flash_token_attention = token_attention.flash_token_attention
    inside = mask > 0
    diff = np.stack([np.abs(a.astype(int) - b.astype(int))[inside]
                     for a, b in zip(kernel_out, plain_out)])
    outside = max(int(np.abs(a.astype(int) - b.astype(int))[~inside].max())
                  for a, b in zip(kernel_out, plain_out))
    log(f"[{phase}] {dtype} full width, {len(kernel_out)} frames: kernel route "
        f"{dt_kernel:.2f} s, plain route {dt_plain:.2f} s, uint8 difference inside the "
        f"mask max {int(diff.max())} mean {diff.mean():.4f}, outside max {outside}")
    if outside:
        raise AssertionError(f"[{phase}] {dtype}: routes differ outside the mask")
    return int(diff.max()), float(diff.mean())


def check_routes(phase, make_run, mask):
    """fp32 within MAX_U8_DIFF, bf16 within the max and mean limits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32_max, _ = routes_u8_diff(phase, "float32", make_run("float32"), mask)
    if f32_max > MAX_U8_DIFF:
        raise AssertionError(f"[{phase}] fp32 kernel vs plain route differ by {f32_max} "
                             f"> {MAX_U8_DIFF}")
    bf16_max, bf16_mean = routes_u8_diff(phase, "bfloat16", make_run("bfloat16"), mask)
    if bf16_max > BF16_MAX_U8_DIFF or bf16_mean > BF16_MEAN_U8_DIFF:
        raise AssertionError(f"[{phase}] bf16 kernel vs plain route: max {bf16_max} (limit "
                             f"{BF16_MAX_U8_DIFF}), mean {bf16_mean:.3f} (limit "
                             f"{BF16_MEAN_U8_DIFF})")
    return f32_max, bf16_max, bf16_mean


def phase_d(card, frames, mask):
    """The route checks, then fp32 sttn-auto through the kernel on all the
    frames (TF32 off, as check_routes left it): one warm run and MAIN_RUNS
    timed runs, checked as phase c checks its runs."""
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.ops import token_attention

    inpainters = {}

    def make_run(dtype):
        inpainters[dtype] = inpainter = STTNAutoInpainter(
            config=Config(compute_dtype=dtype), device="cuda")
        return lambda: run_video(inpainter, frames[:inpainter.clip_gap], mask)[1]

    diffs = check_routes("d", make_run, mask)
    inpainter = inpainters["float32"]
    n, _, dt = run_video(inpainter, frames, mask)
    log(f"[d] fp32 warm pass: {n} frames in {dt:.2f} s")
    fps = []
    for run in range(MAIN_RUNS):
        token_attention.launches = 0
        n, out, dt = run_video(inpainter, frames, mask)
        launches, want = token_attention.launches, expected_auto_launches(inpainter, len(frames))
        if n != len(frames) or len(out) != len(frames):
            raise AssertionError(f"[d] wrote {n} frames ({len(out)} kept) of {len(frames)}")
        if launches != want or launches == 0:
            raise AssertionError(f"[d] kernel launches {launches}, expected {want}")
        check_frames(frames, out, mask, "d")
        fps.append(n / dt)
        log(f"[d] sttn-auto 1080p fp32 run {run + 1}: {fps[-1]:.2f} frames/s ({dt:.3f} s for "
            f"{n} frames, kernel launches {launches}, TF32 off) on {card}")
    return (*diffs, fps)


def subtitle_video(path, n):
    """An n-frame 1920x1080 mp4 (cv2, mp4v): a drifting colour gradient with
    a subtitle line drawn on the frames of SUB_FRAMES."""
    import cv2

    yy, xx = np.mgrid[0:H, 0:W + 4 * n].astype(np.float32)
    base = np.stack([(xx * 0.11 + yy * 0.05) % 256, (xx * 0.07 + 80) % 256,
                     (yy * 0.2 + xx * 0.02) % 256], axis=-1).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), DET_FPS, (W, H))
    try:
        for i in range(1, n + 1):
            frame = np.ascontiguousarray(base[:, 4 * i:4 * i + W])
            for frames, (xmin, xmax, ymin, ymax) in SUB_FRAMES.items():
                if i in frames:
                    cv2.putText(frame, f"synthetic subtitle line {i}", (xmin + 10, ymax - 15),
                                cv2.FONT_HERSHEY_SIMPLEX, 1.6, (255, 255, 255), 4)
            writer.write(frame)
    finally:
        writer.release()


def phase_e(card, video, phase="e", mode="PP_OCRv5_SERVER"):
    """Detection at full width (see the module docstring); phase k runs it
    with the mobile preset."""
    from vsr_tpu_torch.config import Config, SubtitleDetectMode
    from vsr_tpu_torch.detect.dbnet import DBNet
    from vsr_tpu_torch.detect.detector import SubtitleDetector
    from vsr_tpu_torch.detect.postprocess import db_postprocess
    from vsr_tpu_torch.detect.preprocess import preprocess_frame
    from vsr_tpu_torch.io.video import VideoReader

    mode = SubtitleDetectMode(mode)
    preset = "server" if mode == SubtitleDetectMode.PP_OCRv5_SERVER else "mobile"
    det = SubtitleDetector(video, config=Config(subtitle_detect_mode=mode), device="cuda")
    if preset == "mobile":
        tame_lcnet(det._ensure_weights())
    (_, dt_warm) = timed(det.find_subtitle_frame_no)
    found, dt = timed(det.find_subtitle_frame_no)
    sampled = len(range(0, N_FRAMES, det.sample_step))
    log(f"[{phase}] {preset} DBNet: find_subtitle_frame_no, {N_FRAMES} frames {W}x{H} at {DET_FPS} fps, 1 in "
        f"{det.sample_step} sampled ({sampled} frames, batches of {det.batch_size}): "
        f"{dt:.3f} s ({sampled / dt:.2f} sampled frames/s; warm call {dt_warm:.3f} s) on {card}")
    log(f"[{phase}] frames with boxes: {len(found)}; boxes: "
        f"{sorted({b for boxes in found.values() for b in boxes})[:8]}")

    reader = VideoReader(video)
    for _ in range(15):  # frame 15 carries the subtitle line
        ok, frame = reader.read()
    reader.release()
    batch = preprocess_frame(frame)[None]
    got = det.probability_maps(batch)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = det.model(torch.from_numpy(batch).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu_model = DBNet(preset=preset).eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in det.model.state_dict().items()})
    with torch.inference_mode():
        flops, (want, dt_cpu) = count_flops(
            cpu_model, lambda: timed(lambda: cpu_model(torch.from_numpy(batch)).numpy()))
    gflop = flops / 1e9
    err, err_tf32 = float(np.abs(got - want).max()), float(np.abs(tf32 - want).max())
    boxes = [q.astype(int).tolist() for q in db_postprocess(got[0, ..., 0], frame.shape[:2])]
    log(f"[{phase}] frame 15 at {batch.shape[1]}x{batch.shape[2]}: probability map in "
        f"[{got.min():.4f}, {got.max():.4f}], max |card - CPU| {err:.3e} (TF32 off, limit "
        f"{DET_TOL:g}), {err_tf32:.3e} with TF32 on (not used); CPU forward {dt_cpu:.2f} s; "
        f"boxes {boxes}")
    if not np.isfinite(got).all() or err > DET_TOL:
        raise AssertionError(f"[{phase}] detector on the card vs CPU: max |err| {err} > {DET_TOL}")

    x = torch.from_numpy(np.repeat(batch, det.batch_size, axis=0)).cuda()
    with torch.inference_mode():
        torch.backends.cudnn.allow_tf32 = True
        fwd_tf32_ms = cuda_ms(lambda: det.model(x), 5)
        torch.backends.cudnn.allow_tf32 = False
        fwd_ms = cuda_ms(lambda: det.model(x), 5)
    post_ms = 1e3 * timed(lambda: [db_postprocess(got[0, ..., 0], frame.shape[:2])
                                   for _ in range(10)])[1] / 10
    log(f"[{phase}] {preset} DBNet forward, batch {det.batch_size} at {batch.shape[1]}x{batch.shape[2]}, "
        f"fp32 TF32 off: {fwd_ms:.2f} ms device time ({fwd_ms / det.batch_size:.2f} ms a "
        f"frame; {fwd_tf32_ms:.2f} ms with TF32 on, not used); {gflop:.1f} GFLOP a frame "
        f"in its convolutions, {gflop * det.batch_size / fwd_ms:.1f} TFLOP/s; db_postprocess "
        f"{post_ms:.2f} ms a frame on the host, on {card}")
    return {"find_s": dt, "sampled_frames_per_s": sampled / dt, "max_abs_err_vs_cpu": err,
            "max_abs_err_vs_cpu_tf32": err_tf32, "forward_ms_batch8": fwd_ms,
            "forward_ms_batch8_tf32": fwd_tf32_ms, "gflop_per_frame": gflop,
            "postprocess_ms": post_ms, "frames_with_boxes": len(found)}


def tame_lcnet(model):
    """Scale each LearnableRepLayer branch's BatchNorm by LCNET_BRANCH_SCALE
    (see there), in place."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if re.search(r"(conv_kxk_\d|conv_1x1)\.bn$|\.identity$", name):
                m.weight.mul_(LCNET_BRANCH_SCALE)
    return model


def count_flops(model, fn):
    """(FLOPs of the convolutions that fn() runs through model, fn()'s
    result), counted with forward hooks."""
    flops = []
    hooks = [m.register_forward_hook(lambda m, i, o: flops.append(conv_flops(m, i[0], o)))
             for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    return sum(flops), out


def conv_flops(m, x, out) -> int:
    """Multiply-adds x 2 of one Conv2d / ConvTranspose2d call."""
    if isinstance(m, nn.ConvTranspose2d):  # every input pixel meets the whole kernel
        taps = m.out_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
        return 2 * x.numel() * taps
    return 2 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]


class FixedDetector:
    """A fixed frame -> boxes map in place of the DBNet detector; a picture
    gets frame PICTURE_FRAME's boxes."""

    def find_subtitle_frame_no(self, sub_remover=None):
        return {f: [box] for frames, box in SUB_FRAMES.items() for f in frames}

    def detect_subtitle(self, img):
        return self.find_subtitle_frame_no()[PICTURE_FRAME]


def expected_det_launches(model, chunks_clips, stride):
    """8 blocks x windows per chunk, summed over the (chunk frames, clip)
    pairs that ran."""
    return len(model.transformer) * sum(-(-clip // stride) for _, clip in chunks_clips)


def phase_f(card, frames, mask, video, tmp, profile):
    from vsr_tpu_torch.config import Config, InpaintMode
    from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter
    from vsr_tpu_torch.io.video import read_video_info
    from vsr_tpu_torch.masks.intervals import (
        batch_generator, expand_frame_ranges, filter_and_merge_intervals,
        find_continuous_ranges_with_same_mask)
    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.pipeline import SubtitleRemover

    cfg = Config(compute_dtype="bfloat16")
    inpainter = STTNDetInpainter(config=cfg, device="cuda")
    _, dt = timed(lambda: inpainter(frames[:50], mask))
    log(f"[f] warm pass: 50 frames in {dt:.2f} s")
    clip = cfg.get_sttn_max_load_num()
    chunks = [(len(frames[s:s + clip]), clip) for s in range(0, len(frames), clip)]
    want = expected_det_launches(inpainter.model, chunks, cfg.sttn_neighbor_stride)
    fps = []
    for run in range(MAIN_RUNS):
        token_attention.launches = 0
        out, dt = timed(lambda: inpainter(frames, mask))
        launches = token_attention.launches
        log(f"[f] sttn-det run {run + 1}: {len(out)} frames, {len(chunks)} chunks of {clip}, "
            f"kernel launches {launches} (expected {want})")
        if len(out) != len(frames):
            raise AssertionError(f"[f] {len(out)} frames out of {len(frames)}")
        if launches != want or launches == 0:
            raise AssertionError(f"[f] kernel launches {launches}, expected {want}")
        check_frames(frames, out, mask, "f")
        fps.append(len(out) / dt)
        log(f"[f] sttn-det {W}x{H} bf16 run {run + 1}: {fps[-1]:.2f} frames/s "
            f"({dt:.3f} s for {len(out)} frames) on {card}")
    if profile:
        from vsr_tpu_torch.inpaint import sttn_det

        profile_run(lambda: inpainter(frames, mask), len(frames), card, "f",
                    "chip_smoke_profile_sttn_det.txt")
        host_breakdown(lambda: inpainter(frames, mask), len(frames), [
            (sttn_det.cv2, "resize", "crop + resize (cv2)"), (sttn_det, "paste_band", "paste"),
            *engine_targets(inpainter)], "f")

    out_path = os.path.join(tmp, "sttn_det_out.mp4")
    remover = SubtitleRemover(video, output_path=out_path,
                              config=Config(compute_dtype="bfloat16",
                                            inpaint_mode=InpaintMode.STTN_DET),
                              device="cuda")
    remover._detector = FixedDetector()
    sub_list = remover._detector.find_subtitle_frame_no()
    ranges = filter_and_merge_intervals(expand_frame_ranges(
        find_continuous_ranges_with_same_mask(sub_list),
        cfg.subtitle_timeline_backward_frame_count, cfg.subtitle_timeline_forward_frame_count),
        cfg.sttn_reference_length)
    runs = []
    for s, e in ranges:
        for batch in batch_generator(range(s, e + 1), clip):
            t = len(batch)
            runs.append((t, min(clip, max(t, cfg.sttn_reference_length))))
    want = expected_det_launches(inpainter.model, runs, cfg.sttn_neighbor_stride)
    token_attention.launches = 0
    _, dt = timed(remover.run)
    launches = token_attention.launches
    info = read_video_info(out_path)
    log(f"[f] SubtitleRemover.run() sttn-det on the mp4: ranges {ranges}, chunks (frames, "
        f"clip) {runs}, token counts N {sorted({144 * (11 + -(-c // 10)) for _, c in runs})}, "
        f"kernel launches {launches} (expected {want}); {info.frame_count} frames "
        f"{info.width}x{info.height} written in {dt:.2f} s ({N_FRAMES / dt:.2f} frames/s end "
        f"to end, mp4v) on {card}")
    if launches != want or launches == 0:
        raise AssertionError(f"[f] remover kernel launches {launches}, expected {want}")
    if (info.frame_count, info.width, info.height) != (N_FRAMES, W, H):
        raise AssertionError(f"[f] output {info}, expected {N_FRAMES} frames {W}x{H}")
    return want, fps


def phase_g(frames, mask):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_det import STTNDetInpainter

    def make_run(dtype):
        inpainter = STTNDetInpainter(config=Config(compute_dtype=dtype), device="cuda")
        return lambda: inpainter(frames[:50], mask)

    return check_routes("g", make_run, mask)


def tame_lama(model):
    """Scale each residual block's second BatchNorm by LAMA_RESIDUAL_SCALE
    (see there), in place: seeded random weights all the same, whose
    output is not saturated, so the comparisons of phase i see numbers."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if re.fullmatch(r"block\d+\.conv2\.bn_[lg]", name):
                m.weight.mul_(LAMA_RESIDUAL_SCALE)
    return model


def lama_inpainter(dtype):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.lama import LamaInpainter

    inpainter = LamaInpainter(config=Config(compute_dtype=dtype), device="cuda")
    tame_lama(inpainter.model)
    return inpainter


def band_batch(inpainter, frames, mask):
    """The first band's geometry and its first batch of crops and mask, on
    the card, as LamaInpainter._inpaint_band stages them."""
    from vsr_tpu_torch.inpaint import lama
    from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

    m3 = mask[:, :, None]
    ymin, ymax = get_inpaint_area_by_mask(W, H, int(W * 3 / 16), m3)[0][:2]
    r0, out_h = inpainter.band_geometry(m3, ymin, ymax)
    crops = [lama.pad_to_modulo(f[ymin:ymax]) for f in frames[:lama.BAND_BATCH]]
    d_img = inpainter._stage(crops, lama.BAND_BATCH).cuda()
    d_mask = inpainter._stage([lama.pad_to_modulo(m3[ymin:ymax])], 1).cuda()
    return (ymin, ymax, r0, out_h), d_img, d_mask


def phase_h(card, frames, mask, profile):
    from vsr_tpu_torch.inpaint import lama
    from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
    from vsr_tpu_torch.ops import token_attention

    inpainter = lama_inpainter("bfloat16")
    m3 = mask[:, :, None]
    bands = [(b[0], b[1], *inpainter.band_geometry(m3, b[0], b[1]))
             for b in get_inpaint_area_by_mask(W, H, int(W * 3 / 16), m3)]
    batches = -(-len(frames) // lama.BAND_BATCH)
    log(f"[h] LaMa band path: bands (ymin, ymax, r0, out_h) {bands}, batches of "
        f"{lama.BAND_BATCH} ({batches} a band for {len(frames)} frames, the tail padded)")
    _, dt = timed(lambda: inpainter(frames[:lama.BAND_BATCH], mask))
    log(f"[h] warm pass: {lama.BAND_BATCH} frames in {dt:.2f} s")
    fps = []
    for run in range(MAIN_RUNS):
        token_attention.launches = 0
        out, dt = timed(lambda: inpainter(frames, mask))
        if token_attention.launches:
            raise AssertionError(f"[h] the LaMa path launched token attention "
                                 f"{token_attention.launches} times")
        if len(out) != len(frames):
            raise AssertionError(f"[h] {len(out)} frames out of {len(frames)}")
        check_frames(frames, out, mask, "h")
        fps.append(len(out) / dt)
        log(f"[h] lama {W}x{H} bf16 run {run + 1}: {fps[-1]:.2f} frames/s "
            f"({dt:.3f} s for {len(out)} frames; hand-kernel launches 0) on {card}")

    (ymin, ymax, r0, out_h), d_img, d_mask = band_batch(inpainter, frames, mask)
    B = lama.BAND_BATCH

    def band_forward():
        return inpainter._band_forward(inpainter.model, d_img, d_mask, r0, out_h, W)

    batch_ms = cuda_ms(band_forward, 5)
    full_ms = cuda_ms(lambda: inpainter._forward(d_img, d_mask), 5)
    with torch.inference_mode():
        flops, _ = count_flops(inpainter.model, band_forward)
        full_flops, _ = count_flops(inpainter.model, lambda: inpainter._forward(d_img, d_mask))
    tflops = flops / batch_ms / 1e9
    device_s = len(bands) * batches * batch_ms / 1e3
    wall_s = len(frames) / max(fps)
    log(f"[h] one band batch ({B} x {ymax - ymin}x{W}, out_rows ({r0}, {out_h})): "
        f"{batch_ms:.2f} ms device time ({batch_ms / B:.3f} ms a frame); the convolutions "
        f"{flops / B / 1e12:.3f} TFLOP a frame, {tflops:.1f} TFLOP/s = "
        f"{100 * tflops * 1e12 / PEAK_FLOPS['bfloat16']:.1f}% of the bf16 peak; without "
        f"out_rows {full_ms:.2f} ms, {full_flops / B / 1e12:.3f} TFLOP a frame; on {card}")
    log(f"[h] {len(frames)} frames: device ~{device_s:.3f} s ({len(bands) * batches} batches) "
        f"of the fastest run's {wall_s:.3f} s wall; the rest is host time not hidden "
        f"behind the device")
    if profile:
        profile_run(lambda: inpainter(frames, mask), len(frames), card, "h",
                    "chip_smoke_profile_lama.txt")
        host_breakdown(lambda: inpainter(frames, mask), len(frames), [
            (inpainter, "_stage", "crop + staging (pinned)"), (inpainter, "_upload", "H2D"),
            (inpainter, "_band_forward", "forward dispatch"),
            (inpainter, "_wait", "fetch (device wait + D2H)"), (inpainter, "_paste", "paste")],
            "h")
    return inpainter, {"fps": fps, "bands": bands, "batch": B, "band_batch_ms": batch_ms,
                       "band_batch_ms_without_out_rows": full_ms,
                       "tflop_per_frame": flops / B / 1e12,
                       "tflop_per_frame_without_out_rows": full_flops / B / 1e12,
                       "tflops": tflops, "device_s_estimate": device_s}


def phase_i(card, frames, mask, bf16):
    from vsr_tpu_torch.models.lama import LamaGenerator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = lama_inpainter("float32")
    cpu_model = LamaGenerator().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in f32.model.state_dict().items()})
    rng = np.random.default_rng(SEED)
    img = rng.uniform(0, 1, (1, 256, 512, 3)).astype(np.float32)
    msk = np.zeros((1, 256, 512, 1), np.float32)
    msk[:, 180:230, 60:450] = 1.0
    with torch.inference_mode():
        got = f32.model(torch.from_numpy(img).cuda(), torch.from_numpy(msk).cuda()).cpu().numpy()
        want, dt_cpu = timed(lambda: cpu_model(torch.from_numpy(img), torch.from_numpy(msk)).numpy())
    err = float(np.abs(got - want).max())
    log(f"[i] LaMa full width at 256x512, card fp32 (TF32 off) vs CPU fp32: max |err| "
        f"{err:.3e} (limit {LAMA_CPU_TOL:g}), output in [{want.min():.4f}, {want.max():.4f}] "
        f"std {want.std():.4f}; CPU forward {dt_cpu:.2f} s")
    if not np.isfinite(got).all() or err > LAMA_CPU_TOL:
        raise AssertionError(f"[i] LaMa card vs CPU: max |err| {err} > {LAMA_CPU_TOL}")

    (ymin, ymax, r0, out_h), d_img, d_mask = band_batch(bf16, frames, mask)
    comps = [inp._band_forward(inp.model, d_img, d_mask, r0, out_h, W).cpu().numpy().astype(int)
             for inp in (bf16, f32)]
    diff = np.abs(comps[0] - comps[1])
    hole = np.broadcast_to(mask[None, ymin + r0:ymin + r0 + out_h, :, None] > 0, diff.shape)
    u8_max, u8_mean = int(diff[hole].max()), float(diff[hole].mean())
    log(f"[i] one band batch, bf16 vs fp32 on the card: uint8 inside the mask max {u8_max} "
        f"(limit {LAMA_BF16_MAX_U8}), mean {u8_mean:.4f} (limit {LAMA_BF16_MEAN_U8}); "
        f"outside max {int(diff[~hole].max())}")
    if diff[~hole].any() or u8_max > LAMA_BF16_MAX_U8 or u8_mean > LAMA_BF16_MEAN_U8:
        raise AssertionError(f"[i] LaMa bf16 vs fp32: max {u8_max}, mean {u8_mean:.4f}, "
                             f"outside the mask {int(diff[~hole].max())}")
    return {"max_abs_err": err, "limit": LAMA_CPU_TOL, "bf16_vs_fp32_u8_max": u8_max,
            "bf16_vs_fp32_u8_mean": u8_mean}


def phase_j(card, video, tmp, inpainter):
    import cv2

    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.io.video import VideoReader
    from vsr_tpu_torch.masks.mask import create_mask
    from vsr_tpu_torch.pipeline import SubtitleRemover

    reader = VideoReader(video)
    for _ in range(PICTURE_FRAME):
        _, frame = reader.read()
    reader.release()
    picture = os.path.join(tmp, "picture.png")
    cv2.imwrite(picture, frame)
    box = FixedDetector().detect_subtitle(frame)
    hole = create_mask((H, W), box, Config().subtitle_area_deviation_pixel) > 0
    times = {}
    for run, lama in (("cold", None), ("warm", inpainter)):
        out_path = os.path.join(tmp, f"picture_{run}.png")
        remover = SubtitleRemover(picture, output_path=out_path,
                                  config=Config(compute_dtype="bfloat16"), device="cuda")
        remover._detector = FixedDetector()
        remover._lama = lama
        _, times[run] = timed(remover.run)
        back = cv2.imread(out_path)
        if back is None or back.shape != frame.shape:
            raise AssertionError(f"[j] {run}: wrote {None if back is None else back.shape}")
        changed = float(np.abs(back.astype(int) - frame.astype(int))[hole].mean())
        how = "the remover builds its LaMa" if lama is None else "LaMa built"
        log(f"[j] picture mode {W}x{H} ({run}: {how}): run() {times[run]:.3f} s, "
            f"mean |out - in| inside the mask {changed:.2f} on {card}")
        if changed == 0:
            raise AssertionError(f"[j] {run}: the picture did not change inside the mask")
    return times


def propainter_inpainter(dtype):
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.propainter import PropainterInpainter

    return PropainterInpainter(config=Config(compute_dtype=dtype), device="cuda")


def stage_times(inpainter, run):
    """run() with CUDA events around each stage method of the inpainter
    (PP_STAGES): (its result, its wall seconds, {stage: device ms between
    the stage's events, summed over its calls})."""
    events = {}

    def wrap(fn, label):
        def wrapper(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.setdefault(label, []).append((start, end))
            return out
        return wrapper

    for attr, label in PP_STAGES.items():
        setattr(inpainter, attr, wrap(getattr(inpainter, attr), label))
    try:
        out, dt = timed(run)
    finally:
        for attr in PP_STAGES:
            delattr(inpainter, attr)  # back to the class's method
    return out, dt, {label: sum(s.elapsed_time(e) for s, e in pairs)
                     for label, pairs in events.items()}


def propainter_flops(inpainter, n_frames, band_h, band_w, hole):
    """FLOPs of each stage of one clip of n_frames band crops band_h x band_w
    under the float mask ``hole`` (already dilated): the inpainter's own
    stage methods, run on the meta device (shapes only, nothing computed)
    under torch's FlopCounterMode, which counts the matmuls and
    convolutions. Image propagation has none (gathers and blends)."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.copy(inpainter)
    meta.device = torch.device("meta")
    for name in ("raft", "flow_net", "generator"):
        setattr(meta, name, copy.deepcopy(getattr(inpainter, name)).to("meta"))
    frames_n = torch.zeros((n_frames, 3, band_h, band_w), device="meta")
    masks = torch.zeros((n_frames, 1, band_h, band_w), device="meta")
    mw = inpainter._masked_window_set(hole)

    def count(fn):
        counter = FlopCounterMode(display=False)
        with counter:
            out = fn()
        return out, counter.get_total_flops()

    flops = {}
    with torch.inference_mode():
        flows, flops["flows"] = count(lambda: meta._compute_flows(frames_n))
        _, flops["completion"] = count(lambda: meta._complete_flows(*flows, masks))
        enc, flops["encode"] = count(lambda: meta._encode_clip(frames_n, masks, masks))
        _, flops["window sweep"] = count(lambda: meta._sweep_windows(
            enc, *flows, masks, masks, frames_n.to(torch.uint8), masks[0] > 0,
            inpainter._mask_rows(hole), None if mw is None else torch.as_tensor(mw, device="meta")))
    return flops


def phase_l(card, frames, mask, profile):
    from vsr_tpu_torch.inpaint import propainter
    from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
    from vsr_tpu_torch.ops import token_attention

    # what a PyTorch process gets by default (phase b turned both off):
    # cuDNN convolutions may use TF32, fp32 matmuls do not
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    inpainter = propainter_inpainter("bfloat16")
    clip = frames[:PP_FRAMES]
    bands = get_inpaint_area_by_mask(W, H, int(W * 3 / 16), mask[:, :, None], multiple=8)
    ymin, ymax = bands[0][:2]
    hole = propainter.dilate_mask(mask[ymin:ymax], inpainter.mask_dilation)
    rows = inpainter._mask_rows(hole)
    mw = inpainter._masked_window_set(hole)
    n_windows = len(inpainter._windows(PP_FRAMES))
    log(f"[l] ProPainter band path: bands {bands} ({ymax - ymin}x{W}), dilated hole rows "
        f"{rows} of the band, attention windows with hole "
        f"{'all' if mw is None else len(mw)}; {n_windows} windows over {PP_FRAMES} frames")
    flops = propainter_flops(inpainter, PP_FRAMES, ymax - ymin, W, hole)
    log("[l] FLOPs of one clip (FlopCounterMode, meta device): " +
        ", ".join(f"{k} {v / 1e12:.3f} TFLOP" for k, v in flops.items()))
    dilated = np.zeros((H, W), np.float32)
    dilated[ymin:ymax] = hole
    _, dt = timed(lambda: inpainter(clip, mask))
    log(f"[l] warm pass: {PP_FRAMES} frames in {dt:.2f} s")
    fps, stages, peak = [], {}, 0.0
    for run in range(PP_RUNS):
        token_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out, dt, stages = stage_times(inpainter, lambda: inpainter(clip, mask))
        peak = torch.cuda.max_memory_allocated() / 1e9
        if token_attention.launches:
            raise AssertionError(f"[l] the ProPainter path launched token attention "
                                 f"{token_attention.launches} times")
        if len(out) != len(clip):
            raise AssertionError(f"[l] {len(out)} frames out of {len(clip)}")
        check_frames(clip, out, dilated, "l")
        fps.append(len(out) / dt)
        log(f"[l] propainter {W}x{H} bf16 run {run + 1}: {fps[-1]:.2f} frames/s ({dt:.3f} s "
            f"for {len(out)} frames; hand-kernel launches 0; peak memory {peak:.2f} GB) on {card}")
        log(f"[l] run {run + 1} device time by stage (CUDA events): " +
            ", ".join(f"{k} {v:.1f} ms" + (f" ({flops[k] / v / 1e9:.1f} TFLOP/s)"
                                           if flops.get(k) else "")
                      for k, v in stages.items()) +
            f"; sum {sum(stages.values()):.1f} ms of {1e3 * dt:.1f} ms wall")
    inside = dilated > 0
    change = np.mean([np.abs(o.astype(int) - f.astype(int))[inside].mean()
                      for o, f in zip(out, clip)])
    log(f"[l] mean |out - in| inside the dilated hole {change:.2f} uint8")
    if profile:
        profile_run(lambda: inpainter(clip, mask), PP_FRAMES, card, "l",
                    "chip_smoke_profile_propainter.txt")
    return inpainter, {"fps": fps, "band": [int(ymin), int(ymax), W], "hole_rows": list(rows),
                       "windows": n_windows,
                       "windows_with_hole": None if mw is None else int(len(mw)),
                       "stage_ms": stages, "tflop": {k: v / 1e12 for k, v in flops.items()},
                       "peak_memory_gb": peak, "mean_u8_change_in_hole": float(change)}


def phase_m(card, frames, mask, bf16):
    """(see the module docstring)"""
    import copy

    from vsr_tpu_torch.inpaint import propainter
    from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask
    from vsr_tpu_torch.models.propainter import raft_bi_flows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = propainter_inpainter("float32")
    dev = f32.device
    rng = np.random.default_rng(SEED)
    out = {}
    with torch.inference_mode():
        # RAFT on one pair: a crop of the noise frame and the same shifted by (5, 3)
        pair = synthetic_video(1)[0][:140, :272].astype(np.float32) / 127.5 - 1
        img1 = torch.from_numpy(np.ascontiguousarray(pair[:128, :256])).permute(2, 0, 1)[None]
        img2 = torch.from_numpy(np.ascontiguousarray(pair[3:131, 5:261])).permute(2, 0, 1)[None]
        cpu_raft = copy.deepcopy(f32.raft).cpu()
        got = f32.raft(img1.to(dev), img2.to(dev)).cpu()
        want, dt_cpu = timed(lambda: cpu_raft(img1, img2))
        err = float((got - want).abs().max())
        log(f"[m] RAFT ({f32.raft.iters} iterations, {f32.raft.corr_levels} levels, radius "
            f"{f32.raft.corr_radius}) on one 128x256 pair, card fp32 (TF32 off) vs CPU: max "
            f"|flow err| {err:.3e} px (limit {PP_FLOW_TOL:g}), flow |mean| "
            f"{float(want.abs().mean()):.3f} max {float(want.abs().max()):.3f} px; CPU "
            f"{dt_cpu:.2f} s")
        if not torch.isfinite(got).all() or err > PP_FLOW_TOL:
            raise AssertionError(f"[m] RAFT card vs CPU: {err} > {PP_FLOW_TOL}")
        out["raft_flow_max_abs_err_px"] = err

        # raft_bi_flows on a 4-frame crop of the noise clip (7 px a frame):
        # every frame encoded once, both directions of the 3 pairs in one call
        crop = np.stack([f[:128, :256] for f in synthetic_video(4)]).astype(np.float32)
        clip4 = torch.from_numpy(crop / 127.5 - 1).permute(0, 3, 1, 2)[None].contiguous()
        x = clip4[0].to(dev)
        (ff, fb), dt_card = timed(lambda: raft_bi_flows(f32.raft, clip4.to(dev)))
        def vs_per_pair(raft, flows, frames):
            return max(float((f[0, t] - raft(frames[i:i + 1], frames[j:j + 1])[0]).abs().max())
                       for t in range(3) for f, i, j in ((flows[0], t, t + 1),
                                                         (flows[1], t + 1, t)))

        pair_err = vs_per_pair(f32.raft, (ff, fb), x)
        again = max(float((a - b).abs().max())
                    for a, b in zip((ff, fb), raft_bi_flows(f32.raft, clip4.to(dev))))
        enc_batch = float((f32.raft.encode(x)[0] - torch.cat(
            [f32.raft.encode(x[i:i + 1])[0] for i in range(4)])).abs().max())
        (cpu_ff, cpu_fb), dt_cpu = timed(lambda: raft_bi_flows(cpu_raft, clip4))
        cpu_err = max(float((ff.cpu() - cpu_ff).abs().max()), float((fb.cpu() - cpu_fb).abs().max()))
        cpu_pair_err = vs_per_pair(cpu_raft, (cpu_ff, cpu_fb), clip4[0])
        finite = bool(torch.isfinite(ff).all() and torch.isfinite(fb).all())
        log(f"[m] raft_bi_flows on a 4-frame 128x256 crop of the noise clip, card fp32 (TF32 "
            f"off): flows {tuple(ff.shape)} each way, {1e3 * dt_card:.1f} ms wall (first call); "
            f"max |err| vs RAFT.forward on each pair on the card {pair_err:.3e} px, vs the CPU "
            f"{cpu_err:.3e} px (limit {PP_FLOW_TOL:g} each); on the CPU vs RAFT.forward on "
            f"each pair {cpu_pair_err:.3e} px; a second call on the card {again:.3e} px apart; "
            f"fnet on the 4 frames at once vs one at a time on the card {enc_batch:.3e}; "
            f"forward flow |mean| {float(cpu_ff.abs().mean()):.3f} px; CPU {dt_cpu:.2f} s")
        if not finite or pair_err > PP_FLOW_TOL or cpu_err > PP_FLOW_TOL:
            raise AssertionError(f"[m] raft_bi_flows: finite {finite}, vs per pair {pair_err} px, "
                                 f"vs CPU {cpu_err}")
        out.update({"bi_flows_vs_per_pair_px": pair_err, "bi_flows_card_vs_cpu_px": cpu_err,
                    "bi_flows_cpu_vs_per_pair_px": cpu_pair_err, "bi_flows_second_call_px": again,
                    "raft_fnet_batch_vs_single": enc_batch})

        # the full-width generator on one small window: 3 local frames, 2 refs
        cpu_gen = copy.deepcopy(f32.generator).cpu()
        T, lt, h, w = 5, 3, 64, 128
        masked = torch.from_numpy(rng.uniform(-1, 1, (1, T, 3, h, w)).astype(np.float32))
        masks = torch.zeros((1, T, 1, h, w))
        masks[..., 24:44, 16:112] = 1.0
        masked = masked * (1 - masks)
        flows = tuple(torch.from_numpy(rng.normal(0, 2, (1, lt - 1, 2, h, w)).astype(np.float32))
                      for _ in range(2))

        def gen_forward(model, device):
            args = [t.to(device) for t in (masked, masks, masks)]
            enc = model.encode(*args)
            return model.forward_encoded(enc, tuple(f.to(device) for f in flows), args[1],
                                         args[2], lt).cpu()

        got = gen_forward(f32.generator, dev)
        want, dt_cpu = timed(lambda: gen_forward(cpu_gen, "cpu"))
        err = float((got - want).abs().max())
        log(f"[m] generator (channel {f32.generator.channel}, hidden {f32.generator.hidden}, "
            f"{f32.generator.depths} blocks) on a {T}-frame {h}x{w} window, card fp32 vs CPU: "
            f"max |err| {err:.3e} (limit {PP_GEN_TOL:g}), output std {float(want.std()):.4f}; "
            f"CPU {dt_cpu:.2f} s")
        if not torch.isfinite(got).all() or err > PP_GEN_TOL:
            raise AssertionError(f"[m] generator card vs CPU: {err} > {PP_GEN_TOL}")
        out["generator_max_abs_err"] = err

        # one full-width band window, the generator in bf16 against fp32
        ymin, ymax = get_inpaint_area_by_mask(W, H, int(W * 3 / 16), mask[:, :, None],
                                              multiple=8)[0][:2]
        hole = propainter.dilate_mask(mask[ymin:ymax], f32.mask_dilation)
        clip = [f[ymin:ymax] for f in frames[:11]]
        rgb = torch.from_numpy(np.stack(clip)).to(dev).flip(-1).permute(0, 3, 1, 2).contiguous()
        frames_n = rgb.float() / 255.0 * 2.0 - 1.0
        m = torch.from_numpy(hole).to(dev)[None, None].expand(len(clip), 1, *hole.shape)
        flows_f, flows_b = f32._compute_flows(frames_n)
        comp_f, comp_b = f32._complete_flows(flows_f, flows_b, m)
        updated, upd_masks = f32._propagate_images(frames_n, m, comp_f, comp_b)
        ns, rs = f32._windows(len(clip))[0]
        sel, pair = torch.tensor(ns + rs, device=dev), torch.tensor(ns[:-1], device=dev)
        mw = f32._masked_window_set(hole)
        mw = None if mw is None else torch.as_tensor(mw, device=dev)
        preds = []
        for inp in (bf16, f32):
            g = inp.generator
            enc = g.encode(updated[None, sel], m[None, sel], upd_masks[None, sel])
            pred = g.forward_encoded(enc, (comp_f[None, pair], comp_b[None, pair]), m[None, sel],
                                     upd_masks[None, sel], len(ns), masked_windows=mw)
            preds.append(((pred[0] + 1.0) / 2.0 * 255.0).clamp(0, 255).to(torch.uint8).cpu())
        inside = torch.from_numpy(hole > 0).expand_as(preds[0])
        diff = (preds[0].int() - preds[1].int()).abs()[inside]
        u8_max, u8_mean = int(diff.max()), float(diff.float().mean())
        sat = float(((preds[1] == 0) | (preds[1] == 255))[inside].float().mean())
        log(f"[m] one band window ({len(ns)} local + {len(rs)} ref frames of "
            f"{ymax - ymin}x{W}), generator bf16 vs fp32 on the card: uint8 inside the hole max "
            f"{u8_max} (limit {PP_BF16_MAX_U8}), mean {u8_mean:.4f} (limit {PP_BF16_MEAN_U8}); "
            f"fp32 output saturated at 0 or 255 in {100 * sat:.1f}% of the hole; completed flow "
            f"|mean| {float(comp_f.abs().mean()):.3f} px, RAFT flow |max| "
            f"{float(flows_f.abs().max()):.2f} px")
        if u8_max > PP_BF16_MAX_U8 or u8_mean > PP_BF16_MEAN_U8:
            raise AssertionError(f"[m] ProPainter bf16 vs fp32: max {u8_max}, mean {u8_mean:.4f}")
        out.update({"bf16_vs_fp32_u8_max": u8_max, "bf16_vs_fp32_u8_mean": u8_mean,
                    "fp32_saturated_share": sat,
                    "limits": {"flow_px": PP_FLOW_TOL, "generator": PP_GEN_TOL,
                               "u8_max": PP_BF16_MAX_U8, "u8_mean": PP_BF16_MEAN_U8}})
    return out


class CountingInpainter:
    """Passes calls on to an inpainter and keeps each call's frame count
    and wall seconds (to the device's end)."""

    def __init__(self, inner):
        self.inner, self.calls, self.seconds = inner, [], 0.0

    def __call__(self, frames, mask):
        self.calls.append(len(frames))
        out, dt = timed(lambda: self.inner(frames, mask))
        self.seconds += dt
        return out


class PropainterDetector(FixedDetector):
    """(f)'s fixed map plus frame 80 alone, a one-frame range for LaMa."""

    def find_subtitle_frame_no(self, sub_remover=None):
        return {**super().find_subtitle_frame_no(), 80: [(560, 1360, 950, 1010)]}


def phase_n(card, video, tmp, inpainter):
    from vsr_tpu_torch.config import Config, InpaintMode
    from vsr_tpu_torch.io.video import read_video_info
    from vsr_tpu_torch.masks.intervals import (
        batch_generator, find_continuous_ranges_with_same_mask, split_range_by_scene)
    from vsr_tpu_torch.pipeline import SubtitleRemover
    from vsr_tpu_torch.scenes.content import get_scene_div_frame_no

    # a user's process: PyTorch's defaults (phase m turned cuDNN's TF32 off)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = os.path.join(tmp, "propainter_out.mp4")
    remover = SubtitleRemover(video, output_path=out_path,
                              config=Config(compute_dtype="bfloat16",
                                            inpaint_mode=InpaintMode.PROPAINTER),
                              device=inpainter.device)
    remover._detector = PropainterDetector()
    remover._propainter = counting = CountingInpainter(inpainter)
    cuts, dt_scenes = timed(lambda: get_scene_div_frame_no(video))
    ranges = split_range_by_scene(find_continuous_ranges_with_same_mask(
        remover._detector.find_subtitle_frame_no()), cuts)
    _, dt, stages = stage_times(inpainter, remover.run)
    info = read_video_info(out_path)
    log(f"[n] SubtitleRemover.run() propainter on the mp4: scene cuts {cuts}, ranges {ranges}, "
        f"ProPainter clips {counting.calls}, LaMa for frame 80; {info.frame_count} frames "
        f"{info.width}x{info.height} written in {dt:.2f} s ({N_FRAMES / dt:.2f} frames/s end to "
        f"end, mp4v) on {card}; of it ProPainter {counting.seconds:.2f} s (" +
        ", ".join(f"{k} {v:.1f} ms" for k, v in stages.items()) +
        f"), scene detection ~{dt_scenes:.2f} s (timed apart), the rest LaMa (built by the "
        f"remover), decode, encode")
    clips = sorted(len(b) for s, e in ranges for b in batch_generator(
        range(s, e + 1), remover.config.propainter_max_load_num) if len(b) > 1)
    if sorted(counting.calls) != clips or remover._lama is None:
        raise AssertionError(f"[n] ProPainter clips {counting.calls}, LaMa built: "
                             f"{remover._lama is not None}")
    if (info.frame_count, info.width, info.height) != (N_FRAMES, W, H):
        raise AssertionError(f"[n] output {info}, expected {N_FRAMES} frames {W}x{H}")
    return {"run_s": dt, "propainter_s": counting.seconds, "stage_ms": stages,
            "scene_detection_s": dt_scenes, "scene_cuts": cuts,
            "propainter_clips": counting.calls}


# ---- phase o: the model bootstrap ----

# the driving mask of (c) as SubtitleRemover's sub area (ymin, ymax, xmin, xmax)
SUB_AREA = (960, 1040, 300, 1620)
BOOTSTRAP_FAMILIES = {"converted": 6, "missing": 2}


def _conv_spec(spec, name, cout, cin, kh, kw=None, bias=True):
    spec[f"{name}.weight"] = (cout, cin, kh, kh if kw is None else kw)
    if bias:
        spec[f"{name}.bias"] = (cout,)


def _bn_spec(spec, name, c):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        spec[f"{name}.{leaf}"] = (c,)
    spec[f"{name}.num_batches_tracked"] = ()


def _sttn_spec(channel=256, stack=8):
    """sttn-auto/infer_model.pth's netG (and sttn-det/sttn.pth's)."""
    spec = {}
    for name, cout, cin in (("encoder.0", 64, 3), ("encoder.2", 64, 64),
                            ("encoder.4", 128, 64), ("encoder.6", channel, 128)):
        _conv_spec(spec, name, cout, cin, 3)
    for i in range(stack):
        for emb in ("query_embedding", "key_embedding", "value_embedding"):
            _conv_spec(spec, f"transformer.{i}.attention.{emb}", channel, channel, 1)
        for name in ("attention.output_linear.0", "feed_forward.conv.0", "feed_forward.conv.2"):
            _conv_spec(spec, f"transformer.{i}.{name}", channel, channel, 3)
    for name, cout, cin in (("decoder.0.conv", 128, channel), ("decoder.2", 64, 128),
                            ("decoder.4.conv", 64, 64), ("decoder.6", 3, 64)):
        _conv_spec(spec, name, cout, cin, 3)
    return spec


def _raft_spec():
    """raft-things.pth (RAFT's extractor and update block), with the
    'module.' prefix of the nn.DataParallel it was saved from."""
    spec = {}
    for net, has_bn in (("fnet", False), ("cnet", True)):
        _conv_spec(spec, f"{net}.conv1", 64, 3, 7)
        if has_bn:
            _bn_spec(spec, f"{net}.norm1", 64)
        in_planes = 64
        for layer, planes in ((1, 64), (2, 96), (3, 128)):
            for blk in (0, 1):
                base = f"{net}.layer{layer}.{blk}"
                _conv_spec(spec, f"{base}.conv1", planes, in_planes, 3)
                _conv_spec(spec, f"{base}.conv2", planes, planes, 3)
                if has_bn:
                    _bn_spec(spec, f"{base}.norm1", planes)
                    _bn_spec(spec, f"{base}.norm2", planes)
                if (layer > 1 and blk == 0) or in_planes != planes:
                    _conv_spec(spec, f"{base}.downsample.0", planes, in_planes, 1)
                    if has_bn:
                        _bn_spec(spec, f"{base}.norm3", planes)
                in_planes = planes
        _conv_spec(spec, f"{net}.conv2", 256, 128, 1)
    u = "update_block"
    _conv_spec(spec, f"{u}.encoder.convc1", 256, 4 * 9 ** 2, 1)
    _conv_spec(spec, f"{u}.encoder.convc2", 192, 256, 3)
    _conv_spec(spec, f"{u}.encoder.convf1", 128, 2, 7)
    _conv_spec(spec, f"{u}.encoder.convf2", 64, 128, 3)
    _conv_spec(spec, f"{u}.encoder.conv", 126, 256, 3)
    for g in "zrq":
        _conv_spec(spec, f"{u}.gru.conv{g}1", 128, 384, 1, 5)
        _conv_spec(spec, f"{u}.gru.conv{g}2", 128, 384, 5, 1)
    _conv_spec(spec, f"{u}.flow_head.conv1", 256, 128, 3)
    _conv_spec(spec, f"{u}.flow_head.conv2", 2, 256, 3)
    _conv_spec(spec, f"{u}.mask.0", 256, 128, 3)
    _conv_spec(spec, f"{u}.mask.2", 576, 256, 1)
    return {f"module.{k}": v for k, v in spec.items()}


def _deform_align_spec(spec, base, channels, in_channels, cond_channels, groups=16):
    for j, cin in ((0, cond_channels), (2, channels), (4, channels)):
        _conv_spec(spec, f"{base}.conv_offset.{j}", channels, cin, 3)
    _conv_spec(spec, f"{base}.conv_offset.6", 27 * groups, channels, 3)
    _conv_spec(spec, base, channels, in_channels, 3)


def _flow_completion_spec():
    """recurrent_flow_completion.pth."""
    spec = {}
    for name, cout, cin, k in (
            ("downsample.0", 32, 3, (1, 5, 5)), ("encoder1.0.conv1.0", 32, 32, (1, 3, 3)),
            ("encoder1.0.conv2.0", 32, 32, (3, 1, 1)), ("encoder1.2.conv1.0", 64, 32, (1, 3, 3)),
            ("encoder1.2.conv2.0", 64, 64, (3, 1, 1)), ("encoder2.0.conv1.0", 64, 64, (1, 3, 3)),
            ("encoder2.0.conv2.0", 64, 64, (3, 1, 1)), ("encoder2.2.conv1.0", 128, 64, (1, 3, 3)),
            ("encoder2.2.conv2.0", 128, 128, (3, 1, 1)), ("mid_dilation.0", 128, 128, (1, 3, 3)),
            ("mid_dilation.2", 128, 128, (1, 3, 3)), ("mid_dilation.4", 128, 128, (1, 3, 3))):
        spec[f"{name}.weight"] = (cout, cin, *k)
        spec[f"{name}.bias"] = (cout,)
    for d, n_in in (("backward_", 2), ("forward_", 3)):
        _deform_align_spec(spec, f"feat_prop_module.deform_align.{d}", 128, 256, 3 * 128)
        _conv_spec(spec, f"feat_prop_module.backbone.{d}.0", 128, n_in * 128, 3)
        _conv_spec(spec, f"feat_prop_module.backbone.{d}.2", 128, 128, 3)
    _conv_spec(spec, "feat_prop_module.fusion", 128, 256, 1)
    for name, cout, cin, k in (
            ("decoder2.0", 128, 128, 3), ("decoder2.2.conv", 64, 128, 3),
            ("decoder1.0", 64, 64, 3), ("decoder1.2.conv", 32, 64, 3),
            ("upsample.0", 32, 32, 3), ("upsample.2.conv", 2, 32, 3),
            ("edgeDetector.projection.0", 16, 2, 3), ("edgeDetector.mid_layer_1.0", 16, 16, 3),
            ("edgeDetector.mid_layer_2.0", 16, 16, 3), ("edgeDetector.out_layer", 1, 16, 1)):
        _conv_spec(spec, name, cout, cin, k)
    return spec


def _propainter_spec(channel=128, hidden=512, depths=8):
    """ProPainter.pth (the generator)."""
    spec = {}
    widths = [64, 64, 128, 256, 384, 512, 384, 256, channel]
    ins = [5, 64, 64, 128, 256, 640, 768, 640, 512]
    groups = [1, 1, 1, 1, 1, 2, 4, 8, 1]
    for i, (cin, cout, g) in enumerate(zip(ins, widths, groups)):
        _conv_spec(spec, f"encoder.layers.{2 * i}", cout, cin // g, 3)
    spec["ss.embedding.weight"], spec["ss.embedding.bias"] = (hidden, 49 * channel), (hidden,)
    spec["sc.embedding.weight"], spec["sc.embedding.bias"] = (49 * channel, hidden), (49 * channel,)
    for name, cout, cin in (("sc.bias_conv", channel, channel), ("decoder.0.conv", 128, channel),
                            ("decoder.2", 64, 128), ("decoder.4.conv", 64, 64),
                            ("decoder.6", 3, 64)):
        _conv_spec(spec, name, cout, cin, 3)
    for d in ("backward_1", "forward_1"):
        _deform_align_spec(spec, f"feat_prop_module.deform_align.{d}", channel, channel,
                           2 * channel + 2 + 1 + 2)
        _conv_spec(spec, f"feat_prop_module.backbone.{d}.0", channel, 2 * channel + 2, 3)
        _conv_spec(spec, f"feat_prop_module.backbone.{d}.2", channel, channel, 3)
    _conv_spec(spec, "feat_prop_module.fuse.0", channel, 2 * channel + 2, 3)
    _conv_spec(spec, "feat_prop_module.fuse.2", channel, channel, 3)
    for i in range(depths):
        b = f"transformers.transformer.{i}"
        for lin in ("query", "key", "value", "proj"):
            spec[f"{b}.attention.{lin}.weight"] = (hidden, hidden)
            spec[f"{b}.attention.{lin}.bias"] = (hidden,)
        _conv_spec(spec, f"{b}.attention.pool_layer", hidden, 1, 4)
        for norm in ("norm1", "norm2"):
            spec[f"{b}.{norm}.weight"] = spec[f"{b}.{norm}.bias"] = (hidden,)
        spec[f"{b}.mlp.fc1.0.weight"], spec[f"{b}.mlp.fc1.0.bias"] = (1960, hidden), (1960,)
        spec[f"{b}.mlp.fc2.1.weight"], spec[f"{b}.mlp.fc2.1.bias"] = (hidden, 1960), (hidden,)
    return spec


def _lama_spec(ngf=64, n_down=3, n_blocks=18, ratio=0.75):
    """big-lama's FFCResNetGenerator state dict (``model.<index>...``)."""
    spec = {}

    def ffc_bn_act(p, cin, cout, k, gin, gout):
        in_g, out_g = int(cin * gin), int(cout * gout)
        in_l, out_l = cin - in_g, cout - out_g
        for name, ci, co in (("convl2l", in_l, out_l), ("convl2g", in_l, out_g),
                             ("convg2l", in_g, out_l)):
            if ci and co:
                spec[f"{p}.ffc.{name}.weight"] = (co, ci, k, k)
        if in_g and out_g:
            g, half = f"{p}.ffc.convg2g", out_g // 2
            spec[f"{g}.conv1.0.weight"] = (half, in_g, 1, 1)
            _bn_spec(spec, f"{g}.conv1.1", half)
            spec[f"{g}.fu.conv_layer.weight"] = (2 * half, 2 * half, 1, 1)
            _bn_spec(spec, f"{g}.fu.bn", 2 * half)
            spec[f"{g}.conv2.weight"] = (out_g, half, 1, 1)
        if gout != 1:
            _bn_spec(spec, f"{p}.bn_l", out_l)
        if gout != 0:
            _bn_spec(spec, f"{p}.bn_g", out_g)

    ffc_bn_act("model.1", 4, ngf, 7, 0.0, 0.0)
    feats = ngf
    for i in range(n_down):
        out = min(feats * 2, ngf * 8)
        ffc_bn_act(f"model.{2 + i}", feats, out, 3, 0.0, ratio if i == n_down - 1 else 0.0)
        feats = out
    for b in range(n_blocks):
        for conv in ("conv1", "conv2"):
            ffc_bn_act(f"model.{2 + n_down + b}.{conv}", feats, feats, 3, ratio, ratio)
    up = 2 + n_down + n_blocks + 1  # after the ConcatTupleLayer
    for i in range(n_down):
        spec[f"model.{up + 3 * i}.weight"] = (feats, feats // 2, 3, 3)  # ConvTranspose2d
        spec[f"model.{up + 3 * i}.bias"] = (feats // 2,)
        _bn_spec(spec, f"model.{up + 3 * i + 1}", feats // 2)
        feats //= 2
    _conv_spec(spec, f"model.{up + 3 * n_down + 1}", 3, ngf, 7)
    return spec


def _i3d_spec(num_classes=400):
    """i3d_rgb_imagenet.pt, the VFID metric's InceptionI3d(400): a bias-free
    Conv3d and a BatchNorm3d per unit, a 1x1x1 logits conv with bias."""
    from vsr_tpu_torch.models.i3d import MIXED

    spec = {}

    def unit(name, cin, cout, k):
        spec[f"{name}.conv3d.weight"] = (cout, cin, k, k, k)
        _bn_spec(spec, f"{name}.bn", cout)

    unit("Conv3d_1a_7x7", 3, 64, 7)
    unit("Conv3d_2b_1x1", 64, 64, 1)
    unit("Conv3d_2c_3x3", 64, 192, 3)
    cin = 192
    for name, (b0, b1a, b1b, b2a, b2b, b3) in MIXED.items():
        for branch, i, o, k in (("b0", cin, b0, 1), ("b1a", cin, b1a, 1), ("b1b", b1a, b1b, 3),
                                ("b2a", cin, b2a, 1), ("b2b", b2a, b2b, 3), ("b3b", cin, b3, 1)):
            unit(f"{name}.{branch}", i, o, k)
        cin = b0 + b1b + b2b + b3
    spec["logits.conv3d.weight"] = (num_classes, cin, 1, 1, 1)
    spec["logits.conv3d.bias"] = (num_classes,)
    return spec


def reference_specs():
    """family -> {key: shape} of each reference checkpoint at full width, in
    the reference's key layout (tests/test_torch_convert.py holds these
    against the state dicts the converter tests build)."""
    return {"sttn": _sttn_spec(), "raft": _raft_spec(),
            "flow_completion": _flow_completion_spec(), "propainter": _propainter_spec(),
            "lama": _lama_spec(), "i3d": _i3d_spec()}


def random_state_dict(spec, seed):
    """Seeded float32 values for a spec, as the reference's checkpoints
    hold: LeCun-scaled kernels, norm scales near 1, small biases and means,
    variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in spec.items():
        leaf = key.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            sd[key] = torch.tensor(0, dtype=torch.long)
            continue
        if leaf == "running_var":
            arr = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif len(shape) > 1:
            arr = rng.standard_normal(shape, dtype=np.float32) * np.float32(
                1 / np.sqrt(np.prod(shape[1:])))
        elif leaf == "weight":
            arr = 1 + 0.05 * rng.standard_normal(shape, dtype=np.float32)
        else:
            arr = 0.05 * rng.standard_normal(shape, dtype=np.float32)
        sd[key] = torch.from_numpy(arr)
    return sd


def write_split(path, parts):
    """Cut ``path`` into filesplit parts beside it (<stem>_<i><ext> and an
    fs_manifest.csv) and remove it, as the reference ships big blobs."""
    import csv

    with open(path, "rb") as f:
        payload = f.read()
    directory, name = os.path.split(path)
    stem, ext = os.path.splitext(name)
    size = -(-len(payload) // parts)
    rows = []
    for i in range(parts):
        fname = f"{stem}_{i + 1}{ext}"
        with open(os.path.join(directory, fname), "wb") as f:
            f.write(payload[i * size:(i + 1) * size])
        rows.append({"filename": fname, "filesize": len(payload[i * size:(i + 1) * size]),
                     "encoding": "", "header": ""})
    with open(os.path.join(directory, "fs_manifest.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, ["filename", "filesize", "encoding", "header"])
        writer.writeheader()
        writer.writerows(rows)
    os.remove(path)


def write_reference_tree(root):
    """The reference's backend/models layout at full width; returns
    {family: checkpoint path}."""
    specs = reference_specs()
    files = {
        "sttn-auto": ("sttn-auto/infer_model.pth", lambda: {"netG": random_state_dict(
            specs["sttn"], SEED)}),
        "sttn-det": ("sttn-det/sttn.pth", lambda: {"netG": random_state_dict(
            specs["sttn"], SEED + 1)}),
        "lama": ("big-lama/big-lama.pt", lambda: random_state_dict(specs["lama"], SEED + 2)),
        "raft": ("propainter/raft-things.pth", lambda: random_state_dict(specs["raft"], SEED + 3)),
        "flow-completion": ("propainter/recurrent_flow_completion.pth",
                            lambda: random_state_dict(specs["flow_completion"], SEED + 4)),
        "propainter": ("propainter/ProPainter.pth",
                       lambda: random_state_dict(specs["propainter"], SEED + 5)),
    }
    paths = {}
    for family, (rel, make) in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(make(), path)
        paths[family] = path
    write_split(paths["lama"], 3)
    return paths


def run_module(args, timeout):
    """``python -m vsr_tpu_torch ARGS`` from the checkout, in a fresh process;
    returns (stdout, seconds); raises on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vsr_tpu_torch", *args],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[o]   {line}")
    if proc.returncode != 0:
        raise AssertionError(f"[o] vsr_tpu_torch {' '.join(args)}: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout, dt


def same_state(a, b, what):
    sa, sb = a.state_dict(), b.state_dict()
    if list(sa) != list(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa):
        raise AssertionError(f"[o] {what}: the .npz route and the reference route differ")


def check_prepared(tree, out, paths):
    """Each .npz strict into the port's module, bit for bit against the
    reference file's route."""
    from vsr_tpu_torch.convert.from_flax import lama_state_dict_from_flax
    from vsr_tpu_torch.convert.torch_lama import load_lama_checkpoint
    from vsr_tpu_torch.inpaint import weights
    from vsr_tpu_torch.models.lama import LamaGenerator
    from vsr_tpu_torch.models.propainter.flow_completion import RecurrentFlowCompleteNet
    from vsr_tpu_torch.models.propainter.generator import ProPainterGenerator
    from vsr_tpu_torch.models.propainter.raft import RAFT
    from vsr_tpu_torch.models.sttn import STTNGenerator

    for family, npz, make, load in (
            ("sttn-auto", "sttn_auto.npz", lambda: STTNGenerator(variant="auto"),
             weights.load_sttn_weights),
            ("sttn-det", "sttn_det.npz", lambda: STTNGenerator(variant="det"),
             weights.load_sttn_weights),
            ("raft", "raft.npz", RAFT, weights.load_raft_weights),
            ("flow-completion", "flow_completion.npz", RecurrentFlowCompleteNet,
             weights.load_flow_completion_weights),
            ("propainter", "propainter.npz", ProPainterGenerator,
             weights.load_propainter_weights)):
        via_npz, via_pth = make(), make()
        load(via_npz, os.path.join(out, npz))
        load(via_pth, paths[family])
        same_state(via_npz, via_pth, family)
    via_npz, via_pth = LamaGenerator(), LamaGenerator()
    weights.load_lama_weights(via_npz, os.path.join(out, "lama.npz"))
    merged = os.path.join(tree, "big-lama", "big-lama.pt")
    via_pth.load_state_dict(lama_state_dict_from_flax(load_lama_checkpoint(merged)), strict=True)
    same_state(via_npz, via_pth, "lama")


def decoded(path):
    from vsr_tpu_torch.io.video import VideoReader

    reader, frames = VideoReader(path), []
    try:
        while True:
            ok, frame = reader.read()
            if not ok:
                return frames
            frames.append(frame)
    finally:
        reader.release()


def phase_o(card, video, tmp):
    import gc

    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.io.video import read_video_info
    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.pipeline import SubtitleRemover

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the subprocess
    tree, out = os.path.join(tmp, "models"), os.path.join(tmp, "models_npz")
    paths, dt_tree = timed(lambda: write_reference_tree(tree))
    size_mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tree)
                  for f in fs) / 1e6
    log(f"[o] reference tree: {len(paths)} checkpoints, {size_mb:.1f} MB, written in "
        f"{dt_tree:.2f} s")

    stdout, prepare_s = run_module(["--prepare-models", tree, "--models", out], 600)
    families = {}
    for line in stdout.splitlines():
        m = re.match(r"\[prepare\] ([\w-]+): (.*)", line)
        if m:
            status = m.group(2)
            families[m.group(1)] = ("missing" if status.startswith("MISSING") else
                                    "error" if status.startswith("FAILED") else
                                    "exists" if status.startswith("up to date") else "converted")
    counts = {s: sum(1 for v in families.values() if v == s) for s in set(families.values())}
    log(f"[o] --prepare-models in {prepare_s:.2f} s (a fresh process, import included): "
        f"{families}")
    if counts != BOOTSTRAP_FAMILIES or any(families[f] != "missing" for f in
                                           ("dbnet-server", "dbnet-mobile")):
        raise AssertionError(f"[o] families {families}, expected {BOOTSTRAP_FAMILIES}")
    _, dt_check = timed(lambda: check_prepared(tree, out, paths))
    log(f"[o] 7 models: .npz route == reference route bit for bit ({dt_check:.2f} s)")

    stdout, warmup_total = run_module(["--warmup", "--warmup-sizes", str(H), str(W),
                                       "--models", out, "--device", "cuda"], 600)
    warmup_s = {m: float(s) for m, s in re.findall(r"\[warmup\] ([\w-]+): ready in ([\d.]+)s",
                                                   stdout)}
    build_s = {m: float(s) for m, s in re.findall(r"\[warmup\] build (.+): ([\d.]+)s", stdout)}
    if set(warmup_s) != {"sttn-auto", "sttn-det", "lama"} or len(build_s) != 2:
        raise AssertionError(f"[o] warm-up reported {warmup_s}, builds {build_s}")
    log(f"[o] --warmup in {warmup_total:.2f} s (a fresh process): modes {warmup_s}, "
        f"builds {build_s} on {card}")

    cfg = Config(compute_dtype="bfloat16")
    outputs, run = [], {}
    for route in ("npz", "pth"):
        path = os.path.join(tmp, f"bootstrap_{route}.mp4")
        remover = SubtitleRemover(video, output_path=path, sub_areas=[SUB_AREA], config=cfg,
                                  checkpoint_dir=out, device="cuda")
        if route == "pth":
            remover._sttn_auto = STTNAutoInpainter(checkpoint_path=paths["sttn-auto"],
                                                   config=cfg, device="cuda")
        token_attention.launches = 0
        _, dt = timed(remover.run)
        launches = token_attention.launches
        want = expected_auto_launches(remover.sttn_auto_inpaint, N_FRAMES)
        info = read_video_info(path)
        log(f"[o] SubtitleRemover.run() sttn-auto from the {route} weights: {info.frame_count} "
            f"frames {info.width}x{info.height} in {dt:.2f} s, kernel launches {launches} "
            f"(expected {want}) on {card}")
        if launches != want or launches == 0:
            raise AssertionError(f"[o] kernel launches {launches}, expected {want}")
        if (info.frame_count, info.width, info.height) != (N_FRAMES, W, H):
            raise AssertionError(f"[o] output {info}, expected {N_FRAMES} frames {W}x{H}")
        outputs.append(decoded(path))
        if route == "npz":
            run = {"run_s": dt, "launches": launches, "frames": info.frame_count,
                   "size": [info.width, info.height]}
    if len(outputs[0]) != N_FRAMES or not all(
            np.array_equal(a, b) for a, b in zip(*outputs)):
        raise AssertionError("[o] the run from the prepared .npz differs from the run from "
                             "infer_model.pth")
    log("[o] the prepared run's frames equal the infer_model.pth run's, bit for bit")
    run["bit_identical_to_pth"] = True
    return {"tree_mb": size_mb, "prepare_s": prepare_s, "families": families,
            "check_s": dt_check, "warmup_process_s": warmup_total, "warmup_s": warmup_s,
            "build_s": build_s, "run_from_prepared": run}



# ---- phase p: the GUI and the batch queue, with workers on the card ----

GUI_STOP_AT = 10  # percent of the third task's progress at which /api/stop is sent
# card memory the queue may leave behind: a running sttn-auto worker held
# ~1500 MiB on an H100 (2223 MiB used with it, 727 MiB after; PERF.md)
GUI_MEMORY_SLACK_MIB = 256


def gui_call(server, path, body=None):
    """One authorised request to the in-process GuiServer; JSON or bytes."""
    import urllib.request

    req = urllib.request.Request(
        server.address + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-VSR-Token": server.token},
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        data = r.read()
        if r.headers.get("Content-Type", "").startswith("application/json"):
            return json.loads(data)
        return data


def card_processes():
    """(pids of the compute processes nvidia-smi lists, MiB of card memory used)."""
    def query(arg):
        return subprocess.run(["nvidia-smi", arg, "--format=csv,noheader,nounits"],
                              capture_output=True, text=True, timeout=60, check=True).stdout
    pids = {int(x) for x in query("--query-compute-apps=pid").split() if x.strip().isdigit()}
    used = int(query("--query-gpu=memory.used").split()[0])
    return pids, used


def task_timings(state, name, seen):
    """A task's worker log lines in /api/state order, its wall seconds from
    the first poll that saw it processing to the first that saw it done,
    and the worker's own processing time (its "processing time:" line)."""
    lines = [e for e in state["logs"] if e["task"] == name]
    processing = [float(m.group(1)) for e in lines
                  for m in [re.match(r"processing time: ([\d.]+)s", e["message"])] if m]
    wall = seen[name]["done"] - seen[name]["processing"]
    return lines, wall, processing[0] if processing else None


def phase_p(card, video, tmp):
    """(see the module docstring)"""
    import cv2

    from vsr_tpu_torch.config import Config, InpaintMode
    from vsr_tpu_torch.gui.server import GuiServer
    from vsr_tpu_torch.io.video import read_video_info
    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.pipeline import SubtitleRemover
    from vsr_tpu_torch.tasks import TaskOptions, TaskRunner, TaskStatus

    torch.cuda.empty_cache()  # this process's cached blocks, for the workers
    models = os.path.join(tmp, "models_npz")
    copy = os.path.join(tmp, "subtitles_copy.mp4")
    shutil.copyfile(video, copy)
    picture = os.path.join(tmp, "gui_picture.png")
    reader = cv2.VideoCapture(video)
    for _ in range(PICTURE_FRAME):
        ok, frame = reader.read()
    reader.release()
    cv2.imwrite(picture, frame)
    outputs = [os.path.join(tmp, f"gui_{i}{ext}") for i, ext in enumerate((".mp4", ".png", ".mp4"))]
    names = [os.path.basename(p) for p in (video, picture, copy)]
    device_line = f"device: cuda:0 ({torch.cuda.get_device_name(0)})"

    old_models = os.environ.get("VSR_TPU_MODELS")
    os.environ["VSR_TPU_MODELS"] = models  # the workers' weights: phase o's prepared .npz
    server = GuiServer(port=0, config=Config(), config_path=os.path.join(tmp, "gui.json"),
                       device="cuda")
    server.start()
    seen = {n: {} for n in names}  # wall-clock times, as the log entries carry
    stop_pid = used_running = None
    try:
        gui_call(server, "/api/tasks", {"paths": [video, picture, copy]})
        for i, out in enumerate(outputs):
            gui_call(server, f"/api/task/{i}/options",
                     {"sub_areas": [list(SUB_AREA)], "output_path": out})
        _, used_before = card_processes()
        t_run = time.time()
        if not gui_call(server, "/api/run", {})["started"]:
            raise AssertionError("[p] /api/run did not start the queue")
        deadline = t_run + 600
        while True:
            state = gui_call(server, "/api/state")
            now = time.time()
            for task in state["tasks"]:
                if task["status"] != "pending":
                    seen[task["name"]].setdefault("processing", now)
                if task["status"] in ("completed", "failed"):
                    seen[task["name"]].setdefault("done", now)
            third = state["tasks"][2]
            if stop_pid is None and third["status"] == "processing" \
                    and third["progress"] > GUI_STOP_AT:
                stop_pid = server.manager._current_proc.pid
                listed, used_running = card_processes()
                gui_call(server, "/api/stop", {})
                log(f"[p] /api/stop at {third['progress']}% of the third task: worker pid "
                    f"{stop_pid} ({'listed' if stop_pid in listed else 'not listed'} by "
                    f"nvidia-smi, card memory used {used_running} MiB)")
            if all("done" in seen[n] for n in names) and not state["running"]:
                break
            if now > deadline:
                raise AssertionError(f"[p] the queue did not finish: {state['tasks']}")
            time.sleep(0.1)
        server.manager.join(30)
        preview = gui_call(server, "/api/preview/0")
    finally:
        server.stop()
        if old_models is None:
            os.environ.pop("VSR_TPU_MODELS", None)
        else:
            os.environ["VSR_TPU_MODELS"] = old_models

    statuses = [t["status"] for t in state["tasks"]]
    errors = [t["error"] for t in state["tasks"]]
    if statuses != ["completed", "completed", "failed"] or errors[2] != "stopped":
        raise AssertionError(f"[p] statuses {statuses}, errors {errors}")
    if state["tasks"][1]["inpaint_mode"] != "lama":
        raise AssertionError(f"[p] the picture task runs {state['tasks'][1]['inpaint_mode']}")
    jpeg = cv2.imdecode(np.frombuffer(preview, np.uint8), cv2.IMREAD_COLOR)
    if jpeg is None or jpeg.shape[1] <= jpeg.shape[0]:
        raise AssertionError("[p] the preview is not a side-by-side JPEG")
    deadline = time.perf_counter() + 30
    while True:  # a killed process's CUDA context is freed shortly after it exits
        listed, used_after = card_processes()
        if stop_pid not in listed or time.perf_counter() > deadline:
            break
        time.sleep(0.5)
    # nvidia-smi may list no pid of a container's processes: the card's memory
    # used must also come back to what it was before the first worker started
    if stop_pid in listed or used_after > used_before + GUI_MEMORY_SLACK_MIB:
        raise AssertionError(f"[p] the stopped worker {stop_pid} still holds the card: "
                             f"{used_after} MiB used, {used_before} MiB before the queue")
    log(f"[p] the stopped worker's pid is gone from nvidia-smi; card memory used "
        f"{used_after} MiB after the queue, {used_before} MiB before it, {used_running} MiB "
        f"with the stopped worker running")

    tasks = []
    for i, name in enumerate(names):
        lines, wall, processing = task_timings(state, name, seen)
        worker = [e for e in lines if not e["message"].startswith("image task:")]
        if not worker or worker[0]["message"] != device_line:
            raise AssertionError(f"[p] task {name}: first worker line "
                                 f"{worker[0]['message'] if worker else None!r}, "
                                 f"expected {device_line!r}")
        row = {"name": name, "mode": state["tasks"][i]["inpaint_mode"],
               "status": statuses[i], "wall_s": wall, "processing_s": processing,
               "startup_s": None if processing is None else wall - processing,
               "to_device_line_s": worker[0]["t"] - seen[name]["processing"]}
        tasks.append(row)
        log(f"[p] task {i + 1} {name} ({row['mode']}, {statuses[i]}): wall {wall:.2f} s from "
            f"processing to done, worker's processing time "
            f"{'-' if processing is None else f'{processing:.1f} s'}, start-up "
            f"{'-' if processing is None else f'{wall - processing:.2f} s'}; first line "
            f"{worker[0]['message']!r} {row['to_device_line_s']:.2f} s after the task started "
            f"on {card}")
    queue_s = max(seen[n]["done"] for n in names) - t_run
    info = read_video_info(outputs[0])
    written = cv2.imread(outputs[1])
    if (info.frame_count, info.width, info.height) != (N_FRAMES, W, H) or written is None:
        raise AssertionError(f"[p] outputs: {info}, picture {written is None}")
    unchanged = bool(np.array_equal(written, cv2.imread(picture)))
    how = ("unchanged (the random DBNet found no text, so LaMa did not run)" if unchanged
           else "inpainted by LaMa")
    log(f"[p] the queue took {queue_s:.2f} s from /api/run; the picture was written {how}")

    # the first task's video in this process, same weights and PyTorch defaults
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    inproc = os.path.join(tmp, "gui_inprocess.mp4")
    remover = SubtitleRemover(video, output_path=inproc, sub_areas=[SUB_AREA],
                              config=Config(compute_dtype="bfloat16"), checkpoint_dir=models,
                              device="cuda")
    token_attention.launches = 0
    _, inproc_s = timed(remover.run)
    launches = token_attention.launches
    a, b = (np.stack(decoded(p)).astype(np.int16) for p in (outputs[0], inproc))
    if a.shape != b.shape:
        raise AssertionError(f"[p] worker output {a.shape}, in-process {b.shape}")
    diff = np.abs(a - b)
    u8_max, u8_mean = int(diff.max()), float(diff.mean())
    log(f"[p] the same video through SubtitleRemover.run() in this process: {inproc_s:.2f} s, "
        f"{launches} kernel launches; worker vs in-process output uint8 max {u8_max}, mean "
        f"{u8_mean:.5f}")
    if u8_max > MAX_U8_DIFF:
        raise AssertionError(f"[p] worker vs in-process max uint8 difference {u8_max}")

    runner = TaskRunner(config=Config(inpaint_mode=InpaintMode.LAMA), device="cuda")
    out_png = os.path.join(tmp, "runner.png")
    task = runner.add(picture, TaskOptions(sub_areas=[SUB_AREA]), output_path=out_png)
    _, runner_s = timed(runner.run_all)
    if task.status != TaskStatus.COMPLETED or cv2.imread(out_png) is None:
        raise AssertionError(f"[p] TaskRunner: {task.status} {task.error}")
    log(f"[p] TaskRunner(device='cuda') on the PNG: completed in {runner_s:.2f} s (spawn, "
        f"set-up and picture mode)")
    return {"tasks": tasks, "queue_s": queue_s, "picture_unchanged": unchanged,
            "worker_vs_inprocess_u8": {"max": u8_max, "mean": u8_mean},
            "inprocess_run_s": inproc_s, "inprocess_launches": launches,
            "stopped_worker_gone": True,
            "card_memory_mib": {"before": used_before, "third_running": used_running,
                                "after": used_after},
            "task_runner_png_s": runner_s}


# ---- phase q: the inpainters' mesh on the card ----

def u8_split_diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def check_split(phase, what, single, split, frac):
    u8_max, share = u8_split_diff(single, split)
    if u8_max > 1 or share > frac:
        raise AssertionError(f"[{phase}] {what}: split vs single max {u8_max} uint8, "
                             f"{100 * share:.3f}% of values differ (limits 1, {100 * frac}%)")
    return u8_max, share


def warm_timed(fn):
    """timed(fn) after one untimed call (cuDNN plans, the allocator)."""
    fn()
    return timed(fn)


def mesh_sttn(model, dev, band_frames, mesh):
    """One chunk through STTNWindowEngine, alone or over the mesh: (frames,
    seconds, kernel launches), after a warm run."""
    from vsr_tpu_torch.inpaint.engine import STTNWindowEngine
    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.parallel.mesh import replicate

    engine = STTNWindowEngine(model, dev, clip_len=len(band_frames), input_hw=(120, 640),
                              stride=5, ref_length=10, window_batch=1,
                              mesh=replicate(model, mesh) if mesh else None)
    engine.fetch(engine.dispatch(band_frames))
    token_attention.launches = 0
    out, dt = timed(lambda: engine.fetch(engine.dispatch(band_frames)))
    return out, dt, token_attention.launches, engine


def phase_q(card, frames, mask):
    """(see the module docstring)"""
    from vsr_tpu_torch.config import Config
    from vsr_tpu_torch.inpaint.lama import LamaInpainter
    from vsr_tpu_torch.inpaint.propainter import PropainterInpainter
    from vsr_tpu_torch.inpaint.sttn_auto import STTNAutoInpainter
    from vsr_tpu_torch.masks.solver import get_inpaint_area_by_mask

    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    meshes = {"two replicas on cuda:0": [dev, dev]}
    if torch.cuda.device_count() >= 2:
        meshes["every card"] = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        log("[q] one card visible: the split runs on one card only (two replicas on cuda:0); "
            "no cross-card copy is exercised")
    cfg = Config(compute_dtype="bfloat16")
    result = {"cards": torch.cuda.device_count(), "meshes": {}}

    sttn = STTNAutoInpainter(config=cfg, device=dev)
    band = get_inpaint_area_by_mask(W, H, sttn._split_h(W), mask[:, :, None])[0]
    band_frames = sttn._stack_band(frames[:50], band)
    single, single_s, single_launches, _ = mesh_sttn(sttn.model, dev, band_frames, None)
    lama = LamaInpainter(config=cfg, device=dev)
    tame_lama(lama.model)
    lama_single, lama_single_s = warm_timed(lambda: lama(frames[:16], mask))
    pp_single_inp = PropainterInpainter(config=cfg, device=dev)
    pp_single, pp_single_s = warm_timed(lambda: pp_single_inp(frames[:20], mask))
    log(f"[q] single device: sttn-auto chunk of 50 frames {single_s:.3f} s ({single_launches} "
        f"launches), LaMa band batch of 16 {lama_single_s:.3f} s, ProPainter 20-frame band "
        f"clip {pp_single_s:.3f} s on {card}")

    for label, mesh in meshes.items():
        split, split_s, launches, engine = mesh_sttn(sttn.model, dev, band_frames, mesh)
        want = 16 * engine.num_windows_sharded // engine.window_batch
        if launches != want or (engine.num_windows_sharded == engine.num_windows
                                and launches != single_launches):
            raise AssertionError(f"[q] {label}: sttn launches {launches}, single device "
                                 f"{single_launches}, expected {want}")
        sttn_diff = check_split("q", f"{label} sttn-auto", single, split, 0.01)

        lama_split_inp = LamaInpainter(config=cfg, device=dev, mesh=mesh)
        for replica in {id(m): m for m in lama_split_inp.replicas}.values():
            replica.load_state_dict(lama.model.state_dict())
        lama_split, lama_split_s = warm_timed(lambda: lama_split_inp(frames[:16], mask))
        lama_diff = check_split("q", f"{label} LaMa", lama_single, lama_split, 0.05)

        pp_split_inp = PropainterInpainter(config=cfg, device=dev, mesh=mesh)
        if not all(torch.equal(a, b) for a, b in zip(
                pp_single_inp.generator.state_dict().values(),
                pp_split_inp.generator.state_dict().values())):
            raise AssertionError("[q] the ProPainter generators' seeded weights differ")
        pp_split, pp_split_s = warm_timed(lambda: pp_split_inp(frames[:20], mask))
        pp_diff = check_split("q", f"{label} ProPainter", pp_single, pp_split, 0.01)
        del lama_split_inp, pp_split_inp
        log(f"[q] {label} ({', '.join(map(str, mesh))}): sttn-auto {split_s:.3f} s, {launches} "
            f"launches ({engine.num_windows_sharded} windows in {len(mesh)} shards), split vs "
            f"single max {sttn_diff[0]} uint8, {100 * sttn_diff[1]:.4f}% differ; LaMa "
            f"{lama_split_s:.3f} s, max {lama_diff[0]}, {100 * lama_diff[1]:.4f}%; ProPainter "
            f"{pp_split_s:.3f} s, max {pp_diff[0]}, {100 * pp_diff[1]:.4f}% on {card}")
        result["meshes"][label] = {
            "devices": [str(d) for d in mesh],
            "sttn": {"s": split_s, "single_s": single_s, "launches": launches,
                     "single_launches": single_launches, "u8_max": sttn_diff[0],
                     "differ": sttn_diff[1]},
            "lama": {"s": lama_split_s, "single_s": lama_single_s, "u8_max": lama_diff[0],
                     "differ": lama_diff[1]},
            "propainter": {"s": pp_split_s, "single_s": pp_single_s, "u8_max": pp_diff[0],
                           "differ": pp_diff[1]}}
    return result


# ---- phase r: training on the card ----

# r2: the STTN trainer's losses on the card against the CPU, same init and
# data, fp32 with TF32 off: the repo's bound for fp32 sums in another order
TRAIN_CPU_RTOL = 1e-4
# r1: a restored trainer's step against the one that never stopped
RESUME_RTOL = 1e-6
# r3 and r4: ProPainter's published training size (configs/train_propainter.json)
PP_TRAIN_HW = (240, 432)


def training_batch(rng, batch, length, h, w):
    """Frames [B, T, H, W, 3] uniform in [-1, 1] and the training set's
    random moving masks [B, T, H, W, 1] (train/dataset.py), float32."""
    from vsr_tpu_torch.train.dataset import create_random_moving_masks

    frames = rng.uniform(-1, 1, (batch, length, h, w, 3)).astype(np.float32)
    masks = np.stack([create_random_moving_masks(rng, length, h, w) for _ in range(batch)])
    return frames, masks[..., None].astype(np.float32)


def smooth_flows(rng, shape, scale=4.0):
    """[..., 2, H, W] flow fields: normal noise at 1/8 scale, upsampled."""
    *lead, c, h, w = shape
    base = rng.normal(0, scale, (int(np.prod(lead)) * c, 1, -(-h // 8), -(-w // 8)))
    up = torch.nn.functional.interpolate(torch.from_numpy(base.astype(np.float32)),
                                         size=(h, w), mode="bilinear", align_corners=False)
    return up.reshape(shape).numpy()


def event_steps(step, batches):
    """Device time (CUDA events) of step(*batch) for each batch, in ms, and
    the last step's metrics as floats."""
    from vsr_tpu_torch.train.sttn_trainer import as_floats

    times, metrics = [], None
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        metrics = as_floats(out)
    return times, metrics


def check_finite(phase, metrics):
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"[{phase}] metrics not finite: {bad}")


def param_copy(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def max_param_diff(a, b):
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max()) for k in a)


def r1_sttn(card, dev, tmp):
    """The STTN GAN trainer at TrainConfig() defaults, warm step + 3 timed,
    then save, restore into a fresh trainer and step both."""
    from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig, as_floats

    cfg = TrainConfig(save_freq=10 ** 9)
    rng = np.random.default_rng(SEED)
    batch = cfg.batch_size
    while True:
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trainer = STTNTrainer(cfg, device=dev, seed=SEED)
            data = [tuple(torch.from_numpy(x).to(dev) for x in training_batch(
                rng, batch, cfg.sample_length, cfg.frame_h, cfg.frame_w)) for _ in range(5)]
            start = param_copy(trainer.generator)
            _, warm = event_steps(trainer.step, data[:1])
            break
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            log(f"[r1] batch {batch} does not fit on {card}; trying {batch // 2}")
            trainer = data = None
            batch //= 2
    check_finite("r1", warm)
    times, metrics = event_steps(trainer.step, data[1:4])
    check_finite("r1", metrics)
    moved = max_param_diff(param_copy(trainer.generator), start)
    if not moved > 0:
        raise AssertionError("[r1] the generator's parameters did not move")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = float(np.mean(times)) / 1000
    frames_s = batch * cfg.sample_length / step_s
    log(f"[r1] STTN GAN step, batch {batch} x {cfg.sample_length} frames of {cfg.frame_w}x"
        f"{cfg.frame_h}, channel 256, 8 blocks, discriminator nf 64: step ms "
        f"{', '.join(f'{t:.1f}' for t in times)} (warm one excluded), {frames_s:.1f} frames/s, "
        f"peak memory {peak:.2f} GiB on {card}; losses {metrics}; generator moved by up to "
        f"{moved:.3g}")

    path, saved_at = trainer.save(tmp), trainer.step_count
    resumed = STTNTrainer(cfg, device=dev, seed=SEED + 7)
    resumed.restore(path)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cont = as_floats(trainer.step(*data[4]))
        again = as_floats(resumed.step(*data[4]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    rel = max(abs(cont[k] - again[k]) / max(abs(cont[k]), 1e-12) for k in cont)
    if rel > RESUME_RTOL:
        raise AssertionError(f"[r1] restored trainer's step differs by {rel:.3g} relative "
                             f"(limit {RESUME_RTOL}): {cont} vs {again}")
    resume_diff = max_param_diff(param_copy(trainer.generator), param_copy(resumed.generator))
    log(f"[r1] saved at step {saved_at}, restored into a fresh trainer: "
        f"next step's losses within {rel:.3g} relative of the trainer that never stopped "
        f"(cudnn.deterministic), generators after it within {resume_diff:.3g}")
    return {"batch": batch, "sample_length": cfg.sample_length,
            "frame_wh": [cfg.frame_w, cfg.frame_h], "step_ms": times, "step_s": step_s,
            "frames_per_s": frames_s, "peak_memory_gib": peak, "losses": metrics,
            "resume_max_rel": rel, "resume_param_max_diff": resume_diff}


def r2_card_vs_cpu(card, dev):
    """Two STTN trainer steps at channel 64, 2 blocks on the card and on
    the CPU from the same init and data."""
    from vsr_tpu_torch.inpaint.weights import init_random_
    from vsr_tpu_torch.models.discriminator import VideoDiscriminator
    from vsr_tpu_torch.models.sttn import STTNGenerator
    from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig, as_floats

    cfg = TrainConfig(batch_size=1, save_freq=10 ** 9)
    gen = STTNGenerator(variant="auto", channel=64, stack_num=2, use_kernel=False)
    init_random_(gen, SEED)
    dis = VideoDiscriminator(nf=16, seed=SEED + 1)
    init_random_(dis, SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    data = [training_batch(rng, 1, cfg.sample_length, cfg.frame_h, cfg.frame_w) for _ in range(2)]
    runs = {}
    for where in (dev, torch.device("cpu")):
        g, d = copy.deepcopy(gen), copy.deepcopy(dis)
        trainer = STTNTrainer(cfg, generator=g, discriminator=d, device=where)
        t0 = time.perf_counter()
        losses = [as_floats(trainer.step(*batch)) for batch in data]
        runs[where.type] = (losses, param_copy(trainer.generator), time.perf_counter() - t0)
    (card_l, card_p, card_s), (cpu_l, cpu_p, cpu_s) = runs["cuda"], runs["cpu"]
    rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
              for a, b in zip(card_l, cpu_l) for k in a)
    if rel > TRAIN_CPU_RTOL:
        raise AssertionError(f"[r2] card vs CPU losses differ by {rel:.3g} relative "
                             f"(limit {TRAIN_CPU_RTOL}): {card_l} vs {cpu_l}")
    pdiff = max_param_diff(card_p, cpu_p)
    log(f"[r2] STTN trainer, channel 64, 2 blocks, nf 16, 1 x 5 frames of 640x120, 2 steps: "
        f"card vs CPU losses within {rel:.3g} relative (limit {TRAIN_CPU_RTOL}), largest "
        f"parameter difference {pdiff:.3g} (Adam with beta1 = 0 moves each by about lr = 1e-4 "
        f"a step); card {card_s:.2f} s, CPU {cpu_s:.2f} s on {card}")
    return {"max_rel": rel, "param_max_diff": pdiff, "card_losses": card_l, "cpu_losses": cpu_l}


def r3_flow(card, dev):
    """Two flow-completion steps at 432x240, 10 frames."""
    from vsr_tpu_torch.train.dataset import create_random_moving_masks
    from vsr_tpu_torch.train.propainter_trainer import FlowCompletionTrainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 2)
    trainer = FlowCompletionTrainer(device=dev, seed=SEED)
    h, w = PP_TRAIN_HW
    data = []
    for _ in range(3):
        flows = smooth_flows(rng, (1, 10, 2, h, w))
        masks = create_random_moving_masks(rng, 10, h, w)[None, :, None].astype(np.float32)
        data.append((flows, masks))
    _, warm = event_steps(trainer.train_step, data[:1])
    times, metrics = event_steps(trainer.train_step, data[1:])
    check_finite("r3", metrics)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[r3] flow completion + edge head, 1 x 10 frames of {w}x{h}: step ms "
        f"{', '.join(f'{t:.1f}' for t in times)} (host Canny targets included; warm one "
        f"excluded), peak memory {peak:.2f} GiB on {card}; losses {metrics}")
    return {"step_ms": times, "peak_memory_gib": peak, "losses": metrics}


def r4_propainter(card, dev):
    """The ProPainter GAN step at full width with the LPIPS term: 432x240,
    10 local + 6 reference frames, batch 1."""
    from vsr_tpu_torch.inpaint.weights import init_random_
    from vsr_tpu_torch.models.lpips import LPIPS
    from vsr_tpu_torch.train.propainter_trainer import PropainterTrainConfig, PropainterTrainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lpips = LPIPS()
    init_random_(lpips, SEED + 3)
    (h, w), l_t, n_ref = PP_TRAIN_HW, 10, 6
    trainer = PropainterTrainer(PropainterTrainConfig(perceptual_weight=0.1), l_t,
                                lpips=lpips, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED + 3)
    data = []
    for _ in range(3):
        frames, masks = training_batch(rng, 1, l_t + n_ref, h, w)
        flows_f, flows_b = (smooth_flows(rng, (1, l_t - 1, 2, h, w), 2.0) for _ in range(2))
        data.append(tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
            np.moveaxis(frames, -1, 2), flows_f, flows_b, np.moveaxis(masks, -1, 2))))
    _, warm = event_steps(trainer.step, data[:1])
    times, metrics = event_steps(trainer.step, data[1:])
    check_finite("r4", metrics)
    if not metrics["perc_loss"] > 0:
        raise AssertionError(f"[r4] the LPIPS term is {metrics['perc_loss']}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[r4] ProPainter GAN step, generator channel 128, hidden 512, 8 blocks, "
        f"discriminator nf 32, LPIPS (random vgg16), 1 x ({l_t} local + {n_ref} reference) "
        f"frames of {w}x{h}: step ms {', '.join(f'{t:.1f}' for t in times)} (warm one "
        f"excluded), peak memory {peak:.2f} GiB on {card}; losses {metrics}")
    return {"step_ms": times, "peak_memory_gib": peak, "losses": metrics}


def phase_r(card, tmp):
    """(see the module docstring)"""
    from vsr_tpu_torch.ops import token_attention

    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    token_attention.launches = 0
    result = {"r1": r1_sttn(card, dev, tmp), "r2": r2_card_vs_cpu(card, dev),
              "r3": r3_flow(card, dev), "r4": r4_propainter(card, dev)}
    q = torch.randn((1, 64, 32), device=dev, requires_grad=True)
    try:
        token_attention.flash_token_attention(q, q, q)
    except RuntimeError as e:
        if "forward-only" not in str(e):
            raise
        log(f"[r] the kernel under grad raises: {e}")
    else:
        raise AssertionError("[r] the kernel ran on inputs that require grad (F6)")
    if token_attention.launches != 0:
        raise AssertionError(f"[r] the training paths launched the token-attention kernel "
                             f"{token_attention.launches} times")
    result["launches"] = token_attention.launches
    return result



# ---- phase s: training across processes, I3D and VFID, the flow losses ----

# s1: TrainConfig()'s global batch of 8 over two ranks on one card (gloo)
DIST_RANKS = 2
# s2: data 1 x model 2 on one card. Each model rank holds the whole batch's
# activations and gathers every split conv's output (and sums its input's
# gradient) through gloo, on the host: 20.2 s a step at batch 2 on an H100
# (PERF.md), so the check takes one sample
TP_BATCH = 1
# s4: the VFID metric's I3D at its clip size, 16 frames of 224x224; card fp32
# (TF32 off) against the CPU: the repo's activation-parity bound (ROADMAP.md)
I3D_CLIPS, I3D_FRAMES, I3D_HW = 4, 16, 224
I3D_CPU_TOL = 1e-3
VFID_CLIPS = 8
RANKS_TIMEOUT_S = 400


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_main(rank, world, port, fn, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch.distributed as dist

    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(world, fn, *args):
    """fn(rank, *args) in ``world`` spawned processes with torchrun's
    environment; raises with a rank's traceback if one fails, and kills
    them all after RANKS_TIMEOUT_S."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_main, args=(world, _free_port(), fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"[s] {world} ranks of {fn.__name__} did not finish in "
                                 f"{RANKS_TIMEOUT_S} s")


def synced_ms(dev, fn):
    """fn() and its wall time in ms, the device synchronised on both sides
    (a step with collectives waits on the host between its kernels)."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def host_state(module):
    """A module's state dict on the host (a collective under tensor
    parallelism: every rank of the model group calls it)."""
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def s_sttn(dev, mesh, batch, steps, states=None):
    """STTNTrainer at TrainConfig() widths, global batch ``batch``, seeded
    from SEED, ``steps`` steps on the same seeded global batches
    (uniform frames, the training set's moving masks: every sample its
    own). With ``states`` (a directory), one process saves its state after
    every step but the last there, and a mesh run restores it before every
    step but the first, so each step of both starts from the same state.
    Compared free-running, two steps of Adam (beta1 0, eps 1e-8) turn the
    rounding of gradients near eps into parameter differences of about lr,
    between two one-process runs on one card too (PERF.md)."""
    from vsr_tpu_torch.train.sttn_trainer import STTNTrainer, TrainConfig, as_floats

    torch.cuda.empty_cache()
    torch.zeros(1, device=dev)  # the allocator's stats exist once it has allocated
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = TrainConfig(batch_size=batch, save_freq=10 ** 9)
    rng = np.random.default_rng(SEED + 10)
    data = [training_batch(rng, batch, cfg.sample_length, cfg.frame_h, cfg.frame_w)
            for _ in range(steps)]
    trainer = STTNTrainer(cfg, device=dev, seed=SEED, mesh=mesh)
    losses, times = [], []
    for i, (frames, masks) in enumerate(data):
        if states and mesh is not None and i > 0:
            trainer.restore(os.path.join(states, f"ckpt_{i}.pt"))
        out, ms = synced_ms(dev, lambda: trainer.step(frames, masks))
        losses.append(as_floats(out))
        times.append(ms)
        if states and mesh is None and i < steps - 1:
            trainer.save(states)
    return {"losses": losses, "step_ms": times, "params": host_state(trainer.generator),
            "sharded": trainer.sharded, "peak_memory_gib":
            torch.cuda.max_memory_allocated(dev) / 2 ** 30}


def s_flow(dev, mesh):
    """One FlowCompletionTrainer step, global batch 2 of 10 frames at PP_TRAIN_HW."""
    from vsr_tpu_torch.train.dataset import create_random_moving_masks
    from vsr_tpu_torch.train.propainter_trainer import FlowCompletionTrainer
    from vsr_tpu_torch.train.sttn_trainer import as_floats

    torch.cuda.empty_cache()
    h, w = PP_TRAIN_HW
    rng = np.random.default_rng(SEED + 11)
    flows = smooth_flows(rng, (2, 10, 2, h, w))
    masks = np.stack([create_random_moving_masks(rng, 10, h, w) for _ in range(2)])
    trainer = FlowCompletionTrainer(device=dev, seed=SEED, mesh=mesh)
    out, ms = synced_ms(dev, lambda: trainer.train_step(flows, masks[:, :, None].astype(np.float32)))
    return {"losses": [as_floats(out)], "step_ms": [ms], "params": host_state(trainer.net)}


def s_propainter(dev, mesh):
    """One PropainterTrainer step at full width, global batch 2 of 10 local
    + 6 reference frames at PP_TRAIN_HW (no LPIPS term: r4 has it)."""
    from vsr_tpu_torch.train.propainter_trainer import PropainterTrainer
    from vsr_tpu_torch.train.sttn_trainer import as_floats

    torch.cuda.empty_cache()
    (h, w), l_t = PP_TRAIN_HW, 10
    rng = np.random.default_rng(SEED + 12)
    frames, masks = training_batch(rng, 2, l_t + 6, h, w)
    flows_f, flows_b = (smooth_flows(rng, (2, l_t - 1, 2, h, w), 2.0) for _ in range(2))
    batch = (np.moveaxis(frames, -1, 2), flows_f, flows_b, np.moveaxis(masks, -1, 2))
    trainer = PropainterTrainer(num_local_frames=l_t, device=dev, seed=SEED, mesh=mesh)
    out, ms = synced_ms(dev, lambda: trainer.step(*batch))
    return {"losses": [as_floats(out)], "step_ms": [ms], "params": host_state(trainer.generator)}


def s_rank(rank, out_dir, shared, states):
    """One rank of phase s: s1 (data 2, or one rank per card over NCCL when
    not ``shared``; each step from the one process's state in ``states``),
    then on the shared card s2 (data 1 x model 2) and s3; its results go to
    ``out_dir/rank<r>.pt`` (the parameters from rank 0)."""
    import torch.distributed as dist

    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.parallel.distributed import TrainingMesh, init_distributed
    from vsr_tpu_torch.train.sttn_trainer import TrainConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = init_distributed("cuda:0" if shared else "cuda")
    data = TrainingMesh()
    result = {"backend": dist.get_backend(), "device": str(dev),
              "s1": s_sttn(dev, data, TrainConfig().batch_size, 3, states)}
    if shared:
        result["s2"] = s_sttn(dev, TrainingMesh(data=1, model=2), TP_BATCH, 1)
        result["s3_flow"] = s_flow(dev, data)
        result["s3_propainter"] = s_propainter(dev, data)
    result["launches"] = token_attention.launches
    if rank != 0:
        for job in result.values():
            if isinstance(job, dict):
                job.pop("params", None)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def compare_job(ranks, ref):
    """The largest relative difference of any rank's losses from the
    one-process run's at each step, and the largest parameter difference of
    rank 0's network after the last step."""
    rels = [max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                for rank in ranks for got in [rank["losses"][i]] for k in want)
            for i, want in enumerate(ref["losses"])]
    return rels, max_param_diff(ranks[0]["params"], ref["params"])


def s_torchrun(tmp):
    """``torchrun --nproc_per_node=1 -m vsr_tpu_torch.train.train_sttn
    --distributed --steps 2`` on two synthetic frame directories, at
    TrainConfig()'s widths and batch, one rank on cuda:0 over NCCL."""
    import cv2

    data, save = os.path.join(tmp, "train_frames"), os.path.join(tmp, "train_ckpt")
    rng = np.random.default_rng(SEED + 15)
    for v in range(2):
        os.makedirs(os.path.join(data, f"video{v}"))
        for i in range(8):
            cv2.imwrite(os.path.join(data, f"video{v}", f"{i:05d}.jpg"),
                        rng.integers(0, 256, (120, 640, 3), dtype=np.uint8))
    config = os.path.join(tmp, "train_config.json")
    with open(config, "w") as f:
        json.dump({"save_freq": 1000, "log_freq": 1}, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           "-m", "vsr_tpu_torch.train.train_sttn", "--distributed", "--data", data,
           "--config", config, "--steps", "2", "--save-dir", save]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[s]   {line}")
    ckpt = os.path.join(save, "ckpt_2.pt")
    if proc.returncode != 0 or not os.path.exists(ckpt):
        raise AssertionError(f"[s] torchrun train_sttn --distributed: exit {proc.returncode}, "
                             f"checkpoint {'written' if os.path.exists(ckpt) else 'missing'}\n"
                             f"{proc.stderr[-4000:]}")
    step = torch.load(ckpt, map_location="cpu", weights_only=True)["step"]
    if step != 2:
        raise AssertionError(f"[s] the torchrun checkpoint is at step {step}, not 2")
    log(f"[s] torchrun --nproc_per_node=1 train_sttn --distributed --steps 2 (NCCL, batch 8 x 5 "
        f"frames of 640x120, full width): rc 0, {os.path.basename(ckpt)} written, "
        f"{seconds:.1f} s wall (start-up and two steps)")
    return {"rc": proc.returncode, "checkpoint_step": step, "wall_s": seconds}


def s_i3d(card, dev, tmp):
    """The I3D from a full-width reference-format i3d_rgb_imagenet.pt through
    ``python -m vsr_tpu_torch.convert i3d`` and from_flax, loaded strict;
    features of I3D_CLIPS clips on the card against the CPU; VFID of two
    sets of VFID_CLIPS clips; clips/s."""
    from vsr_tpu_torch.convert.from_flax import i3d_state_dict_from_flax
    from vsr_tpu_torch.convert.params_io import load_params
    from vsr_tpu_torch.models.i3d import InceptionI3d
    from vsr_tpu_torch.utils.metrics import vfid

    torch.cuda.empty_cache()
    pt, npz = os.path.join(tmp, "i3d_rgb_imagenet.pt"), os.path.join(tmp, "i3d.npz")
    sd = random_state_dict(_i3d_spec(), SEED + 6)
    torch.save(sd, pt)
    proc = subprocess.run([sys.executable, "-m", "vsr_tpu_torch.convert", "i3d", pt, "-o", npz],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"[s] vsr_tpu_torch.convert i3d: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    model = InceptionI3d().eval()
    model.load_state_dict(i3d_state_dict_from_flax(load_params(npz)), strict=True)
    direct = InceptionI3d()
    direct.load_state_dict(sd, strict=True)
    same_state(model, direct, "I3D (the converter's .npz against the .pt loaded strict)")
    rng = np.random.default_rng(SEED + 13)
    clips = rng.uniform(-1, 1, (I3D_CLIPS, I3D_FRAMES, I3D_HW, I3D_HW, 3)).astype(np.float32)
    with torch.no_grad():
        cpu = model(torch.from_numpy(clips))
        model.to(dev)
        card_out = model(torch.from_numpy(clips).to(dev)).cpu()
    err = float((card_out - cpu).abs().max())
    if not err <= I3D_CPU_TOL:
        raise AssertionError(f"[s] I3D features card vs CPU max |err| {err:.3g} "
                             f"(limit {I3D_CPU_TOL})")
    real = rng.uniform(-1, 1, (VFID_CLIPS, I3D_FRAMES, I3D_HW, I3D_HW, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.3, real.shape), -1, 1).astype(np.float32)

    @torch.no_grad()
    def features(videos):
        return model(torch.from_numpy(videos).to(dev)).cpu()

    features(real)  # warm
    _, ms = synced_ms(dev, lambda: features(real))
    t0 = time.perf_counter()
    value = vfid(real, fake, features)
    vfid_s = time.perf_counter() - t0
    if not np.isfinite(value) or value <= 0:
        raise AssertionError(f"[s] VFID of noisy clips against their originals is {value}")
    clips_s = VFID_CLIPS / (ms / 1e3)
    log(f"[s4] I3D (random reference-format weights, converted through the CLI, loaded "
        f"strict): features of {I3D_CLIPS} clips of {I3D_FRAMES}x{I3D_HW}x{I3D_HW}, card fp32 "
        f"(TF32 off) vs CPU max |err| {err:.3g} (limit {I3D_CPU_TOL}), |features| up to "
        f"{float(cpu.abs().max()):.3g}; a batch of {VFID_CLIPS} clips {ms:.1f} ms with its "
        f"copies ({clips_s:.1f} clips/s) on {card}; VFID of {VFID_CLIPS} clips against noisy "
        f"copies {value:.4g} ({vfid_s:.2f} s with both sets' features and the host sqrtm)")
    return {"card_vs_cpu": err, "batch_ms": ms, "clips_per_s": clips_s, "vfid": value,
            "vfid_s": vfid_s}


def s_flow_losses(dev):
    """The four flow losses on the card (fp32, TF32 off) against the CPU, on
    two 432x240 samples: within TRAIN_CPU_RTOL relative."""
    from vsr_tpu_torch.train import flow_losses as fl

    h, w = PP_TRAIN_HW
    rng = np.random.default_rng(SEED + 14)
    flow = np.ascontiguousarray(np.moveaxis(smooth_flows(rng, (2, 2, h, w)), 1, -1))
    mask = (rng.uniform(size=(2, h, w, 1)) > 0.3).astype(np.float32)
    f1, f2 = (rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32) for _ in range(2))
    cases = {"smoothness": (fl.smoothness_loss, (flow, mask)),
             "second_order_smoothness": (fl.second_order_smoothness_loss, (flow, mask)),
             "ternary": (fl.ternary_loss, (f1, f2, mask)),
             "flow_warp": (fl.flow_warp_loss, (f1, f2, flow, mask))}
    out = {}
    for name, (fn, args) in cases.items():
        cpu = float(fn(*map(torch.from_numpy, args)))
        card_value = float(fn(*(torch.from_numpy(a).to(dev) for a in args)))
        rel = abs(card_value - cpu) / max(abs(cpu), 1e-12)
        if not rel <= TRAIN_CPU_RTOL:
            raise AssertionError(f"[s5] {name}: card {card_value} vs CPU {cpu} ({rel:.3g} "
                                 f"relative, limit {TRAIN_CPU_RTOL})")
        out[name] = {"card": card_value, "cpu": cpu, "rel": rel}
    log(f"[s5] flow losses, 2 x {w}x{h}, card vs CPU: " + ", ".join(
        f"{k} {v['card']:.6g} ({v['rel']:.2g} rel)" for k, v in out.items()))
    return out


def phase_s(card, tmp):
    """(see the module docstring)"""
    from vsr_tpu_torch.ops import token_attention
    from vsr_tpu_torch.train.sttn_trainer import TrainConfig

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # every comparison of phase s runs cuDNN's deterministic algorithms, in
    # this process and in the ranks, as r1's resume check does
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _phase_s(card, tmp, torch.device("cuda", 0), token_attention,
                        TrainConfig().batch_size, t0)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _phase_s(card, tmp, dev, token_attention, batch, t0):
    """Phase s's checks, in order, on ``dev`` with cuDNN deterministic."""
    token_attention.launches = 0
    states = os.path.join(tmp, "s1_states")
    ref = {"s1": s_sttn(dev, None, batch, 3, states), "s2": s_sttn(dev, None, TP_BATCH, 1),
           "s3_flow": s_flow(dev, None), "s3_propainter": s_propainter(dev, None)}
    log(f"[s] one process on {card}: STTN batch {batch} step ms "
        f"{', '.join(f'{t:.1f}' for t in ref['s1']['step_ms'])} (the first warm), peak "
        f"{ref['s1']['peak_memory_gib']:.2f} GiB; batch {TP_BATCH} "
        f"{ref['s2']['step_ms'][0]:.1f} ms; flow {ref['s3_flow']['step_ms'][0]:.1f} ms; "
        f"ProPainter {ref['s3_propainter']['step_ms'][0]:.1f} ms (each a first step)")
    torch.cuda.empty_cache()
    out_dir = os.path.join(tmp, "ranks")
    os.makedirs(out_dir)
    spawn_ranks(DIST_RANKS, s_rank, out_dir, True, states)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
             for r in range(DIST_RANKS)]
    if any(r["backend"] != "gloo" or r["device"] != str(dev) for r in ranks):
        raise AssertionError(f"[s] ranks on one card: {[(r['backend'], r['device']) for r in ranks]}")
    result = {"ranks": DIST_RANKS, "one_process": {
        k: {kk: v for kk, v in job.items() if kk != "params"} for k, job in ref.items()}}
    failures = []

    def check(what, job_ranks, job_ref):
        rels, pdiff = compare_job(job_ranks, job_ref)
        if max(rels) > TRAIN_CPU_RTOL:
            failures.append(f"{what}: losses differ from one process by up to {max(rels):.3g} "
                            f"relative (limit {TRAIN_CPU_RTOL}): "
                            f"{[r['losses'] for r in job_ranks]} vs {job_ref['losses']}")
        return rels, pdiff

    for job, what in (("s1", f"s1 data {DIST_RANKS} x STTN batch {batch}, each step from one "
                             f"process's state before it"),
                      ("s2", "s2 data 1 x model 2"), ("s3_flow", "s3 flow completion"),
                      ("s3_propainter", "s3 ProPainter")):
        rels, pdiff = check(what, [r[job] for r in ranks], ref[job])
        times = [r[job]["step_ms"] for r in ranks]
        peaks = [r[job].get("peak_memory_gib") for r in ranks]
        result[job] = {"max_rel_by_step": rels, "param_max_diff": pdiff, "step_ms": times,
                       "peak_memory_gib": peaks}
        log(f"[s] {what}, {DIST_RANKS} gloo ranks on {card} against one process: losses within "
            f"{', '.join(f'{r:.3g}' for r in rels)} relative by step (limit {TRAIN_CPU_RTOL}), "
            f"largest parameter difference {pdiff:.3g}; step ms by rank "
            f"{[[round(t, 1) for t in r] for r in times]}"
            + (f", peak memory by rank {[round(p, 2) for p in peaks]} GiB" if peaks[0] else ""))
    sharded = ranks[0]["s2"]["sharded"]
    if not sharded:
        raise AssertionError("[s] s2: no convolution was split over the model group")
    result["s2"]["sharded_convs"] = len(sharded)
    log(f"[s2] {len(sharded)} convolutions split over the model group (e.g. {sharded[:3]})")
    n = torch.cuda.device_count()
    if n >= 2 and batch % n == 0:
        nccl_dir = os.path.join(tmp, "ranks_nccl")
        os.makedirs(nccl_dir)
        spawn_ranks(n, s_rank, nccl_dir, False, states)
        nccl = [torch.load(os.path.join(nccl_dir, f"rank{r}.pt"), weights_only=True)
                for r in range(n)]
        rels, pdiff = check(f"s1 NCCL over {n} cards", [r["s1"] for r in nccl], ref["s1"])
        result["s1_nccl"] = {"cards": n, "max_rel_by_step": rels, "param_max_diff": pdiff,
                             "step_ms": [r["s1"]["step_ms"] for r in nccl]}
        log(f"[s1] NCCL, one rank on each of {n} cards: losses within "
            f"{', '.join(f'{r:.3g}' for r in rels)} relative by step, "
            f"largest parameter difference {pdiff:.3g}, step ms "
            f"{[[round(t, 1) for t in r['s1']['step_ms']] for r in nccl]}")
        ranks += nccl
    result["torchrun"] = s_torchrun(tmp)
    result["i3d"] = s_i3d(card, dev, tmp)
    result["flow_losses"] = s_flow_losses(dev)
    launches = token_attention.launches + sum(r["launches"] for r in ranks)
    if launches != 0:
        raise AssertionError(f"[s] the training paths launched the token-attention kernel "
                             f"{launches} times")
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t0
    log(f"[s] token-attention launches in phase s (this process and every rank): {launches}; "
        f"phase s {result['seconds']:.1f} s")
    if failures:
        raise AssertionError("[s] " + "\n[s] ".join(failures))
    return result

def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vsr_tpu_torch.masks.mask import create_mask

    t0 = time.perf_counter()

    def done(phase):
        log(f"[{phase}] done at {time.perf_counter() - t0:.1f} s")

    card = phase_a()
    max_err, cases = phase_b(card)
    done("b")
    frames = synthetic_video(N_FRAMES)
    mask = create_mask((H, W), [(300, 1620, 960, 1040)])  # bench.py's bottom band
    launches, fps = phase_c(card, frames, mask, "--profile" in argv)
    done("c")
    f32_diff, bf16_diff, bf16_mean, fps_f32 = phase_d(card, frames, mask)
    done("d")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        video = os.path.join(tmp, "subtitles.mp4")
        subtitle_video(video, N_FRAMES)
        detection = phase_e(card, video)
        done("e")
        det_launches, det_fps = phase_f(card, frames, mask, video, tmp, "--profile" in argv)
        done("f")
        det_f32, det_bf16, det_bf16_mean = phase_g(frames, mask)
        done("g")
        lama, lama_run = phase_h(card, frames, mask, "--profile" in argv)
        done("h")
        lama_vs_cpu = phase_i(card, frames, mask, lama)
        done("i")
        picture_s = phase_j(card, video, tmp, lama)
        done("j")
        detection_mobile = phase_e(card, video, "k", "PP_OCRv5_MOBILE")
        done("k")
        pp_bf16, pp_run = phase_l(card, frames, mask, "--profile" in argv)
        done("l")
        pp_run["card_vs_cpu"] = phase_m(card, frames, mask, pp_bf16)
        done("m")
        pp_run["remover"] = phase_n(card, video, tmp, pp_bf16)
        done("n")
        del lama, pp_bf16  # their device memory, for phase o's subprocesses
        bootstrap = phase_o(card, video, tmp)
        done("o")
        gui = phase_p(card, video, tmp)
        done("p")
        mesh = phase_q(card, frames, mask)
        done("q")
        training = phase_r(card, tmp)
        done("r")
        training_distributed = phase_s(card, tmp)
        done("s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # one sttn-auto transformer block's two kernel scales, as that path calls them
    main_case = [c for c in cases if c["dtype"] == "bfloat16" and c["path"] == "sttn-auto"]

    def total(key):
        return sum(c[key] for c in main_case)

    print(json.dumps({"kernels": [{
        "name": "flash_token_attention",
        "route": "cuda",
        "source": "vsr_tpu_torch/csrc/token_attention.cu",
        "replaces": "vsr_tpu/ops/pallas_token_attention.py:150",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if all(c["bound_by"] == "operations" for c in main_case)
                    else "bytes",
        "library_ms": total("library_ms"),
        "cases": cases,
        "fps_1080p_bf16": fps,
        "fps_1080p_fp32": fps_f32,
        "full_width_u8_diff": {"float32": f32_diff, "bfloat16_max": bf16_diff,
                               "bfloat16_mean": bf16_mean},
        "launches_sttn_det": det_launches,
        "fps_1080p_bf16_sttn_det": det_fps,
        "full_width_u8_diff_sttn_det": {"float32": det_f32, "bfloat16_max": det_bf16,
                                        "bfloat16_mean": det_bf16_mean},
        "detection": detection,
        "fps_1080p_bf16_lama": lama_run.pop("fps"),
        "lama": lama_run,
        "lama_card_vs_cpu": lama_vs_cpu,
        "picture_s": picture_s,
        "detection_mobile": detection_mobile,
        "fps_1080p_bf16_propainter": pp_run.pop("fps"),
        "propainter": pp_run,
        "bootstrap": bootstrap,
        "gui": gui,
        "mesh": mesh,
        "training": training,
        "training_distributed": training_distributed,
        "card": card,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
