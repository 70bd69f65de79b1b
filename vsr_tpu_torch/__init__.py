"""vsr_tpu_torch — the video subtitle remover in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``vsr_tpu`` (which stays the reference it is
tested against). Plain tensor code is PyTorch; the TPU's Pallas kernels
become CUDA kernels written for sm_90a under ``csrc/``, built with nvcc at
first use. The port imports neither jax nor anything of ``vsr_tpu``: it keeps
its own copies of the host modules it needs.

Package map (each module mirrors its ``vsr_tpu`` namesake):
  cli, pipeline  — command line and orchestrator (sttn-auto, sttn-det, opencv)
  config, i18n, version — settings (same JSON as vsr_tpu's), strings
  io/, masks/, native/ — video I/O, mask, band and interval helpers,
                   g++-built host ops
  detect/        — PP-OCRv5 server DBNet and the video subtitle detector
  inpaint/       — sttn-auto and sttn-det inpainters, window engine, OpenCV
                   mode, weights, paste-back
  models/sttn    — the STTN generator as nn.Modules
  ops/           — patch attention, token-attention kernel wrapper, upsample
  convert/       — JAX-package params -> torch state dicts
  utils/device   — device selection and memory-adaptive chunk length
"""

from vsr_tpu_torch.version import __version__  # noqa: F401
