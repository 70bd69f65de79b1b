"""vsr_tpu_torch — the video subtitle remover in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``vsr_tpu`` (which stays the reference it is
tested against). Plain tensor code is PyTorch; the TPU's Pallas kernels
become CUDA kernels written for sm_90a under ``csrc/``, built with nvcc at
first use. The port imports neither jax nor anything of ``vsr_tpu``: it keeps
its own copies of the host modules it needs.

Package map (each module mirrors its ``vsr_tpu`` namesake):
  cli, pipeline  — command line and orchestrator (sttn-auto)
  config, i18n, version — settings (same JSON as vsr_tpu's), strings
  io/, masks/, native/ — video I/O, mask and band helpers, g++-built host ops
  inpaint/       — sttn-auto inpainter, window engine, weights, paste-back
  models/sttn    — the STTN generator as nn.Modules
  ops/           — patch attention, token-attention kernel wrapper, upsample
  convert/       — JAX-package params -> torch state dict
  utils/device   — device selection and memory-adaptive chunk length
"""

from vsr_tpu_torch.version import __version__  # noqa: F401
