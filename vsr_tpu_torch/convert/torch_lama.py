"""big-lama TorchScript checkpoint conversion, in numpy (a copy of
``vsr_tpu/convert/torch_lama.py`` without jax).

The reference loads LaMa as an opaque TorchScript blob
(backend/inpaint/lama_inpaint.py:13, backend/models/big-lama/big-lama.pt);
``torch.jit.load(path).state_dict()`` exposes the FFCResNetGenerator
parameters. The generator is one big ``nn.Sequential`` named ``model`` whose
indices are fixed by the architecture (ngf=64, 3 downsamples, 18 FFC blocks):

  model.1            stem FFC_BN_ACT (7x7, all-local)     -> stem / stem_bn
  model.{2,3,4}      downsample FFC_BN_ACT (3x3 s2)       -> down{0,1,2}/...
  model.{5..22}      FFCResnetBlock                        -> block{0..17}/...
  model.23           ConcatTupleLayer (no params)
  model.{24,27,30}   ConvTranspose2d (k3 s2 p1 op1)        -> up{0,1,2}
  model.{25,28,31}   BatchNorm2d                           -> up{0,1,2}_bn
  model.34           out Conv2d (7x7, bias)                -> head

FFC internals: ffc.convl2l/convl2g/convg2l -> l2l/l2g/g2l plain convs;
ffc.convg2g is a SpectralTransform {conv1.0 conv, conv1.1 bn, fu.conv_layer,
fu.bn, conv2}; bn_l/bn_g follow. Depending on the export path the blob's
keys may carry ``model.``/``generator.`` wrapper prefixes — keys are
normalized to start at the Sequential index.

tests/test_torch_convert.py holds the output to vsr_tpu's, bit for bit, on
a TorchScript blob and a raw .pth of a torch generator with these names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import convert_state_dict

_N_DOWN = 3
_N_BLOCKS = 18


def _ffc_bn_act_rules(torch_base: str, flax_base: str) -> list:
    """Rules for one FFC_BN_ACT module (spatial convs + spectral transform)."""
    rules = [
        (rf"{torch_base}\.ffc\.convl2l", f"{flax_base}/ffc/l2l", "conv2d"),
        (rf"{torch_base}\.ffc\.convl2g", f"{flax_base}/ffc/l2g", "conv2d"),
        (rf"{torch_base}\.ffc\.convg2l", f"{flax_base}/ffc/g2l", "conv2d"),
        (rf"{torch_base}\.ffc\.convg2g\.conv1\.0",
         f"{flax_base}/ffc/g2g/conv1", "conv2d"),
        (rf"{torch_base}\.ffc\.convg2g\.conv1\.1",
         f"{flax_base}/ffc/g2g/bn1", "batchnorm"),
        (rf"{torch_base}\.ffc\.convg2g\.fu\.conv_layer",
         f"{flax_base}/ffc/g2g/fu/conv", "conv2d"),
        (rf"{torch_base}\.ffc\.convg2g\.fu\.bn",
         f"{flax_base}/ffc/g2g/fu/bn", "batchnorm"),
        (rf"{torch_base}\.ffc\.convg2g\.conv2",
         f"{flax_base}/ffc/g2g/conv2", "conv2d"),
        (rf"{torch_base}\.bn_l", f"{flax_base}/bn_l", "batchnorm"),
        (rf"{torch_base}\.bn_g", f"{flax_base}/bn_g", "batchnorm"),
    ]
    return rules


def _build_rules() -> list:
    rules: list = [
        (r"1\.ffc\.convl2l", "stem", "conv2d"),
        (r"1\.bn_l", "stem_bn", "batchnorm"),
    ]
    for i in range(_N_DOWN):
        rules += _ffc_bn_act_rules(rf"{2 + i}", f"down{i}")
    for b in range(_N_BLOCKS):
        idx = 2 + _N_DOWN + b
        rules += _ffc_bn_act_rules(rf"{idx}\.conv1", f"block{b}/conv1")
        rules += _ffc_bn_act_rules(rf"{idx}\.conv2", f"block{b}/conv2")
    up0 = 2 + _N_DOWN + _N_BLOCKS + 1  # +1 skips ConcatTupleLayer
    for i in range(_N_DOWN):
        rules.append((rf"{up0 + 3 * i}", f"up{i}", "convtranspose2d"))
        rules.append((rf"{up0 + 3 * i + 1}", f"up{i}_bn", "batchnorm"))
    rules.append((rf"{up0 + 3 * _N_DOWN + 1}", "head", "conv2d"))
    return rules


_RULES = _build_rules()
_IDX_RE = re.compile(r"^(?:.*?\.)??(\d+\..*)$")


def _normalize_key(key: str) -> str:
    """Strip wrapper prefixes (model./generator./module.) down to the
    Sequential index the rules are written against."""
    m = _IDX_RE.match(key)
    return m.group(1) if m else key


def convert_lama_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    normalized = {_normalize_key(k): v for k, v in state_dict.items()}
    return convert_state_dict(normalized, _RULES)


def load_lama_checkpoint(path: str) -> Dict[str, Any]:
    """Load big-lama.pt (TorchScript) or a raw .pth state dict and convert."""
    import torch

    try:
        module = torch.jit.load(path, map_location="cpu")
        state_dict = module.state_dict()
    except RuntimeError:
        ckpt = torch.load(path, map_location="cpu")
        state_dict = ckpt.get("state_dict", ckpt)
        state_dict = {k.replace("generator.", "", 1): v
                      for k, v in state_dict.items()}
    return convert_lama_state_dict(state_dict)
