"""ProPainter checkpoint conversion: ProPainter.pth (generator) and
recurrent_flow_completion.pth, in numpy (a copy of
``vsr_tpu/convert/torch_propainter.py`` without jax).

Torch module naming comes from the reference sources
(backend/inpaint/video/model/propainter.py and
recurrent_flow_completion.py); deform-conv offsets live in
``conv_offset.{0,2,4,6}`` stacks, the deform conv's own weight maps to the
bare "kernel" param of the alignment modules.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from vsr_tpu_torch.convert.mapping import convert_state_dict

# ---- generator (ProPainter.pth) ----

_GEN_RULES = []
# encoder convs: layers.{0,2,...,16} -> c0..c8
for i in range(9):
    _GEN_RULES.append((rf"encoder\.layers\.{2 * i}", f"encoder/c{i}", "conv2d"))
_GEN_RULES += [
    (r"ss\.embedding", "ss/embedding", "linear"),
    (r"sc\.embedding", "sc/embedding", "linear"),
    (r"sc\.bias_conv", "sc/bias_conv", "conv2d"),
    (r"decoder\.0\.conv", "dec_deconv0", "conv2d"),
    (r"decoder\.2", "dec_conv1", "conv2d"),
    (r"decoder\.4\.conv", "dec_deconv1", "conv2d"),
    (r"decoder\.6", "dec_conv2", "conv2d"),
]
for torch_dir, flax_dir in (("backward_1", "backward"), ("forward_1", "forward")):
    base = rf"feat_prop_module\.deform_align\.{torch_dir}"
    flax = f"feat_prop_module/{flax_dir}/align"
    _GEN_RULES.append((base, flax, "deform_kernel"))
    for j, off in ((0, "off0"), (2, "off1"), (4, "off2"), (6, "off3")):
        _GEN_RULES.append((base + rf"\.conv_offset\.{j}", f"{flax}/{off}", "conv2d"))
    bb = rf"feat_prop_module\.backbone\.{torch_dir}"
    _GEN_RULES += [
        (bb + r"\.0", f"feat_prop_module/{flax_dir}/bb0", "conv2d"),
        (bb + r"\.2", f"feat_prop_module/{flax_dir}/bb1", "conv2d"),
    ]
_GEN_RULES += [
    (r"feat_prop_module\.fuse\.0", "feat_prop_module/fuse0", "conv2d"),
    (r"feat_prop_module\.fuse\.2", "feat_prop_module/fuse1", "conv2d"),
]
_GEN_RULES += [
    (r"transformers\.transformer\.(\d+)\.attention\.(query|key|value|proj)",
     r"block\1/attention/\2", "linear"),
    (r"transformers\.transformer\.(\d+)\.attention\.pool_layer",
     r"block\1/attention/pool_kernel", "depthwise2d"),
    (r"transformers\.transformer\.(\d+)\.norm1", r"block\1/norm1", "layernorm"),
    (r"transformers\.transformer\.(\d+)\.norm2", r"block\1/norm2", "layernorm"),
    (r"transformers\.transformer\.(\d+)\.mlp\.fc1\.0", r"block\1/mlp/fc1", "linear"),
    (r"transformers\.transformer\.(\d+)\.mlp\.fc2\.1", r"block\1/mlp/fc2", "linear"),
]


def convert_propainter_generator(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    # `attention.valid_ind_rolled` is a registered *buffer* (a constant
    # rolled-window index table, sparse_transformer.py:112-115); we rebuild it
    # in the model, so drop it here.
    filtered = {k: v for k, v in state_dict.items()
                if not k.endswith("valid_ind_rolled")}
    return convert_state_dict(filtered, _GEN_RULES)


# ---- recurrent flow completion (recurrent_flow_completion.pth) ----

_FLOW_RULES = [
    (r"downsample\.0", "down", "conv3d"),
    (r"encoder1\.0\.conv1\.0", "enc1a/conv1", "conv3d"),
    (r"encoder1\.0\.conv2\.0", "enc1a/conv2", "conv3d"),
    (r"encoder1\.2\.conv1\.0", "enc1b/conv1", "conv3d"),
    (r"encoder1\.2\.conv2\.0", "enc1b/conv2", "conv3d"),
    (r"encoder2\.0\.conv1\.0", "enc2a/conv1", "conv3d"),
    (r"encoder2\.0\.conv2\.0", "enc2a/conv2", "conv3d"),
    (r"encoder2\.2\.conv1\.0", "enc2b/conv1", "conv3d"),
    (r"encoder2\.2\.conv2\.0", "enc2b/conv2", "conv3d"),
    (r"mid_dilation\.0", "mid0", "conv3d"),
    (r"mid_dilation\.2", "mid1", "conv3d"),
    (r"mid_dilation\.4", "mid2", "conv3d"),
    (r"feat_prop_module\.fusion", "prop/fusion", "conv2d"),
    (r"decoder2\.0", "dec2a/conv", "conv2d"),
    (r"decoder2\.2\.conv", "dec2b/conv", "conv2d"),
    (r"decoder1\.0", "dec1a/conv", "conv2d"),
    (r"decoder1\.2\.conv", "dec1b/conv", "conv2d"),
    (r"upsample\.0", "upa/conv", "conv2d"),
    (r"upsample\.2\.conv", "upb/conv", "conv2d"),
    (r"edgeDetector\.projection\.0", "edge/proj/conv", "conv2d"),
    (r"edgeDetector\.mid_layer_1\.0", "edge/mid1/conv", "conv2d"),
    (r"edgeDetector\.mid_layer_2\.0", "edge/mid2/conv", "conv2d"),
    (r"edgeDetector\.out_layer", "edge/out", "conv2d"),
]
for torch_dir, flax_dir in (("backward_", "backward"), ("forward_", "forward")):
    base = rf"feat_prop_module\.deform_align\.{torch_dir}"
    flax = f"prop/{flax_dir}/align"
    _FLOW_RULES.append((base, flax, "deform_kernel"))
    for j, off in ((0, "off0"), (2, "off1"), (4, "off2"), (6, "off3")):
        _FLOW_RULES.append(
            (base + rf"\.conv_offset\.{j}", f"{flax}/{off}/conv", "conv2d"))
    bb = rf"feat_prop_module\.backbone\.{torch_dir}"
    _FLOW_RULES += [
        (bb + r"\.0", f"prop/{flax_dir}/bb1/conv", "conv2d"),
        (bb + r"\.2", f"prop/{flax_dir}/bb2/conv", "conv2d"),
    ]


def convert_flow_completion(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return convert_state_dict(state_dict, _FLOW_RULES)


def load_propainter_checkpoints(model_dir: str) -> Dict[str, Dict[str, Any]]:
    """Load+convert ProPainter.pth / recurrent_flow_completion.pth /
    raft-things.pth from a reference model directory."""
    import os

    import torch

    from vsr_tpu_torch.convert.torch_raft import convert_raft_state_dict

    out = {}
    gen = os.path.join(model_dir, "ProPainter.pth")
    if os.path.exists(gen):
        out["generator"] = convert_propainter_generator(
            torch.load(gen, map_location="cpu"))
    flow = os.path.join(model_dir, "recurrent_flow_completion.pth")
    if os.path.exists(flow):
        out["flow_completion"] = convert_flow_completion(
            torch.load(flow, map_location="cpu"))
    raft = os.path.join(model_dir, "raft-things.pth")
    if os.path.exists(raft):
        out["raft"] = convert_raft_state_dict(
            torch.load(raft, map_location="cpu"))
    return out
