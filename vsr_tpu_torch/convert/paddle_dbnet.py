"""PP-OCRv5 DBNet Paddle checkpoint -> flax-layout conversion, in numpy (a
copy of ``vsr_tpu/convert/paddle_dbnet.py`` without jax; the stage tables
come from the port's own ``detect/backbones.py``).

The reference runs its det models through the Paddle C++ runtime
(backend/tools/subtitle_detect.py:41-54) with weights in
backend/models/V5/ch_det*/inference.pdiparams. detect/dbnet.py reconstructs
the exact PP-OCRv5 graphs; this module maps the Paddle parameter program
onto the JAX package's variable tree, which convert/from_flax.py then maps
onto the port's modules:

  * ``DET_RULES[preset]`` — the complete name mapping from Paddle structured
    state-dict keys (train-format ``.pdparams`` layout, e.g.
    ``backbone.blocks5.2.dw_conv.conv_kxk.0.conv.weight``) to flax paths.
  * ``paddle_state_spec(preset)`` — enumerates the full expected Paddle
    parameter program (key -> shape) for each preset, derived from the
    architecture configs. Used to test the mapping against a synthetic
    checkpoint (tests/test_torch_convert.py) and to validate real
    checkpoints key-for-key.
  * ``convert_paddle_det_state_dict`` — the converter. The head's ``thresh``
    branch is optional (Paddle *inference* exports prune it since eval
    forward never touches it); missing thresh parameters are synthesized as
    inference-neutral defaults.

Inference-format blobs (.pdiparams) store values under opaque program names;
``load_pdiparams`` recovers the structured names through paddle.jit.load +
the .pdiparams.info sidecar when the paddle package is available.

Layouts: Paddle conv weights are OIHW (same as torch) -> flax HWIO;
Conv2DTranspose is (I, O, kh, kw) -> flax (kh, kw, O, I) with
transpose_kernel=True; BatchNorm state is weight/bias/_mean/_variance.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

from vsr_tpu_torch.convert.mapping import Rule, convert_state_dict
from vsr_tpu_torch.detect.backbones import (
    _LCNET_DET_CONFIG,
    _LCNET_DET_MV_C,
    HGNETV2_B4_STAGES,
    make_divisible,
)

_C2 = "conv2d"
_CT = "convtranspose2d"
_BN = "batchnorm"
_AF = "affine"

_HEAD_RULES: List[Rule] = [
    (r"head\.(binarize|thresh)\.conv1", r"head/\1/conv1", _C2),
    (r"head\.(binarize|thresh)\.conv_bn1", r"head/\1/conv_bn1", _BN),
    (r"head\.(binarize|thresh)\.conv2", r"head/\1/conv2", _CT),
    (r"head\.(binarize|thresh)\.conv_bn2", r"head/\1/conv_bn2", _BN),
    (r"head\.(binarize|thresh)\.conv3", r"head/\1/conv3", _CT),
    (r"head\.cbn_layer\.last_3\.conv", r"head/cbn_layer/last_3_conv", _C2),
    (r"head\.cbn_layer\.last_3\.bn", r"head/cbn_layer/last_3_bn", _BN),
    (r"head\.cbn_layer\.last_1", r"head/cbn_layer/last_1", _C2),
]

_MOBILE_RULES: List[Rule] = [
    # PPLCNetV3 backbone (rec_lcnetv3.py, det=True)
    (r"backbone\.conv1\.conv", r"backbone/conv1/conv", _C2),
    (r"backbone\.conv1\.bn", r"backbone/conv1/bn", _BN),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.conv_kxk\.(\d+)\.conv",
     r"backbone/\1_\2/\3/conv_kxk_\4/conv", _C2),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.conv_kxk\.(\d+)\.bn",
     r"backbone/\1_\2/\3/conv_kxk_\4/bn", _BN),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.conv_1x1\.conv",
     r"backbone/\1_\2/\3/conv_1x1/conv", _C2),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.conv_1x1\.bn",
     r"backbone/\1_\2/\3/conv_1x1/bn", _BN),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.identity",
     r"backbone/\1_\2/\3/identity", _BN),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.act\.lab",
     r"backbone/\1_\2/\3/act_lab", _AF),
    (r"backbone\.(blocks\d)\.(\d+)\.(dw_conv|pw_conv)\.lab",
     r"backbone/\1_\2/\3/lab", _AF),
    (r"backbone\.(blocks\d)\.(\d+)\.se\.(conv1|conv2)",
     r"backbone/\1_\2/se/\3", _C2),
    (r"backbone\.layer_list\.(\d+)", r"backbone/layer_list_\1", _C2),
    # RSEFPN neck (db_fpn.py)
    (r"neck\.(ins_conv|inp_conv)\.(\d+)\.in_conv", r"neck/\1_\2/in_conv", _C2),
    (r"neck\.(ins_conv|inp_conv)\.(\d+)\.se_block\.(conv1|conv2)",
     r"neck/\1_\2/se_block/\3", _C2),
] + _HEAD_RULES

_SERVER_RULES: List[Rule] = [
    # PPHGNetV2-B4 backbone (pphgnetv2.py, det=True)
    (r"backbone\.stem\.(stem\d[ab]?)\.conv", r"backbone/stem/\1/conv", _C2),
    (r"backbone\.stem\.(stem\d[ab]?)\.bn", r"backbone/stem/\1/bn", _BN),
    (r"backbone\.stages\.(\d+)\.downsample\.conv",
     r"backbone/stages_\1/downsample/conv", _C2),
    (r"backbone\.stages\.(\d+)\.downsample\.bn",
     r"backbone/stages_\1/downsample/bn", _BN),
    (r"backbone\.stages\.(\d+)\.blocks\.(\d+)\.layers\.(\d+)\.(conv1|conv2)\.conv",
     r"backbone/stages_\1/blocks_\2/layers_\3/\4/conv", _C2),
    (r"backbone\.stages\.(\d+)\.blocks\.(\d+)\.layers\.(\d+)\.(conv1|conv2)\.bn",
     r"backbone/stages_\1/blocks_\2/layers_\3/\4/bn", _BN),
    (r"backbone\.stages\.(\d+)\.blocks\.(\d+)\.layers\.(\d+)\.conv",
     r"backbone/stages_\1/blocks_\2/layers_\3/conv", _C2),
    (r"backbone\.stages\.(\d+)\.blocks\.(\d+)\.layers\.(\d+)\.bn",
     r"backbone/stages_\1/blocks_\2/layers_\3/bn", _BN),
    (r"backbone\.stages\.(\d+)\.blocks\.(\d+)"
     r"\.(aggregation_squeeze_conv|aggregation_excite_conv)\.conv",
     r"backbone/stages_\1/blocks_\2/\3/conv", _C2),
    (r"backbone\.stages\.(\d+)\.blocks\.(\d+)"
     r"\.(aggregation_squeeze_conv|aggregation_excite_conv)\.bn",
     r"backbone/stages_\1/blocks_\2/\3/bn", _BN),
    # LKPAN neck (db_fpn.py, mode=large) + IntraCL blocks (intracl.py)
    (r"neck\.(ins_conv|inp_conv|pan_lat_conv)\.(\d+)", r"neck/\1_\2", _C2),
    (r"neck\.pan_head_conv\.(\d+)", r"neck/pan_head_conv_\1", _C2),
    (r"neck\.(incl\d)\.(conv1x1_reduce_channel|conv1x1_return_channel"
     r"|[cvq]_layer_\w+)", r"neck/\1/\2", _C2),
    (r"neck\.(incl\d)\.bn", r"neck/\1/bn", _BN),
] + _HEAD_RULES

DET_RULES: Dict[str, List[Rule]] = {
    "mobile": _MOBILE_RULES,
    "server": _SERVER_RULES,
}


# ---------------------------------------------------------------------------
# Expected Paddle parameter programs
# ---------------------------------------------------------------------------


def _bn(spec, prefix: str, c: int) -> None:
    spec[f"{prefix}.weight"] = (c,)
    spec[f"{prefix}.bias"] = (c,)
    spec[f"{prefix}._mean"] = (c,)
    spec[f"{prefix}._variance"] = (c,)


def _convbn(spec, prefix: str, cin: int, cout: int, k, groups: int = 1) -> None:
    kh, kw = k if isinstance(k, tuple) else (k, k)
    spec[f"{prefix}.conv.weight"] = (cout, cin // groups, kh, kw)
    _bn(spec, f"{prefix}.bn", cout)


def _conv(spec, prefix: str, cin: int, cout: int, k, bias: bool = True,
          groups: int = 1) -> None:
    kh, kw = k if isinstance(k, tuple) else (k, k)
    spec[f"{prefix}.weight"] = (cout, cin // groups, kh, kw)
    if bias:
        spec[f"{prefix}.bias"] = (cout,)


def _rep_layer(spec, prefix: str, cin: int, cout: int, k: int, stride: int,
               groups: int, branches: int = 4) -> None:
    """LearnableRepLayer program (rec_lcnetv3.py)."""
    if cin == cout and stride == 1:
        _bn(spec, f"{prefix}.identity", cin)
    if k > 1:
        _convbn(spec, f"{prefix}.conv_1x1", cin, cout, 1, groups)
    for j in range(branches):
        _convbn(spec, f"{prefix}.conv_kxk.{j}", cin, cout, k, groups)
    spec[f"{prefix}.lab.scale"] = (1,)
    spec[f"{prefix}.lab.bias"] = (1,)
    if stride != 2:
        spec[f"{prefix}.act.lab.scale"] = (1,)
        spec[f"{prefix}.act.lab.bias"] = (1,)


def _head_branch(spec, prefix: str, c: int) -> None:
    """det_db_head.Head program."""
    q = c // 4
    spec[f"{prefix}.conv1.weight"] = (q, c, 3, 3)
    _bn(spec, f"{prefix}.conv_bn1", q)
    spec[f"{prefix}.conv2.weight"] = (q, q, 2, 2)  # Conv2DTranspose (I,O,kh,kw)
    spec[f"{prefix}.conv2.bias"] = (q,)
    _bn(spec, f"{prefix}.conv_bn2", q)
    spec[f"{prefix}.conv3.weight"] = (q, 1, 2, 2)
    spec[f"{prefix}.conv3.bias"] = (1,)


def _head_spec(spec, neck_channels: int, mode: str) -> None:
    _head_branch(spec, "head.binarize", neck_channels)
    _head_branch(spec, "head.thresh", neck_channels)
    mid = neck_channels // (4 if mode == "large" else 8)
    spec["head.cbn_layer.last_3.conv.weight"] = (mid, neck_channels // 4 + 1, 3, 3)
    _bn(spec, "head.cbn_layer.last_3.bn", mid)
    spec["head.cbn_layer.last_1.weight"] = (1, mid, 1, 1)
    spec["head.cbn_layer.last_1.bias"] = (1,)


def _se(spec, prefix: str, c: int, reduction: int = 4) -> None:
    _conv(spec, f"{prefix}.conv1", c, c // reduction, 1)
    _conv(spec, f"{prefix}.conv2", c // reduction, c, 1)


def paddle_state_spec(preset: str, scale: float = 0.75,
                      neck_channels: int = 0) -> Dict[str, Tuple[int, ...]]:
    """Full expected Paddle state-dict program {key: shape} for a preset."""
    spec: Dict[str, Tuple[int, ...]] = {}
    if preset == "mobile":
        nc = neck_channels or 96
        stem = make_divisible(16 * scale)
        _convbn(spec, "backbone.conv1", 3, stem, 3)
        outs = []
        for group in ("blocks2", "blocks3", "blocks4", "blocks5", "blocks6"):
            for i, (k, in_c, out_c, stride, use_se) in enumerate(
                    _LCNET_DET_CONFIG[group]):
                cin = make_divisible(in_c * scale)
                cout = make_divisible(out_c * scale)
                p = f"backbone.{group}.{i}"
                _rep_layer(spec, f"{p}.dw_conv", cin, cin, k, stride, cin)
                if use_se:
                    _se(spec, f"{p}.se", cin)
                _rep_layer(spec, f"{p}.pw_conv", cin, cout, 1, 1, 1)
            outs.append(cout)
        det_outs = []
        for i, mv in enumerate(_LCNET_DET_MV_C):
            _conv(spec, f"backbone.layer_list.{i}", outs[i + 1],
                  int(mv * scale), 1)
            det_outs.append(int(mv * scale))
        # RSEFPN
        for i, cin in enumerate(det_outs):
            _conv(spec, f"neck.ins_conv.{i}.in_conv", cin, nc, 1, bias=False)
            _se(spec, f"neck.ins_conv.{i}.se_block", nc)
            _conv(spec, f"neck.inp_conv.{i}.in_conv", nc, nc // 4, 3,
                  bias=False)
            _se(spec, f"neck.inp_conv.{i}.se_block", nc // 4)
        _head_spec(spec, nc, "small")
    elif preset == "server":
        nc = neck_channels or 256
        # stem 3 -> 32 -> 48
        _convbn(spec, "backbone.stem.stem1", 3, 32, 3)
        _convbn(spec, "backbone.stem.stem2a", 32, 16, 2)
        _convbn(spec, "backbone.stem.stem2b", 16, 32, 2)
        _convbn(spec, "backbone.stem.stem3", 64, 32, 3)
        _convbn(spec, "backbone.stem.stem4", 32, 48, 1)
        stage_outs = []
        for si, stage in enumerate(HGNETV2_B4_STAGES):
            (in_c, mid_c, out_c, num_blocks, downsample, light, k,
             layer_num) = stage
            sp = f"backbone.stages.{si}"
            if downsample:
                _convbn(spec, f"{sp}.downsample", in_c, in_c, 3, groups=in_c)
            for b in range(num_blocks):
                bp = f"{sp}.blocks.{b}"
                block_in = in_c if b == 0 else out_c
                h = block_in
                for li in range(layer_num):
                    lp = f"{bp}.layers.{li}"
                    if light:
                        _convbn(spec, f"{lp}.conv1", h, mid_c, 1)
                        _convbn(spec, f"{lp}.conv2", mid_c, mid_c, k,
                                groups=mid_c)
                    else:
                        _convbn(spec, lp, h, mid_c, k)
                    h = mid_c
                total = block_in + layer_num * mid_c
                _convbn(spec, f"{bp}.aggregation_squeeze_conv", total,
                        out_c // 2, 1)
                _convbn(spec, f"{bp}.aggregation_excite_conv", out_c // 2,
                        out_c, 1)
            stage_outs.append(out_c)
        # LKPAN
        q = nc // 4
        for i, cin in enumerate(stage_outs):
            _conv(spec, f"neck.ins_conv.{i}", cin, nc, 1, bias=False)
            _conv(spec, f"neck.inp_conv.{i}", nc, q, 9, bias=False)
            _conv(spec, f"neck.pan_lat_conv.{i}", q, q, 9, bias=False)
            if i > 0:
                _conv(spec, f"neck.pan_head_conv.{i - 1}", q, q, 3, bias=False)
        for n in range(1, 5):
            ip = f"neck.incl{n}"
            rc = q // 2  # reduce_factor=2
            _conv(spec, f"{ip}.conv1x1_reduce_channel", q, rc, 1)
            for kk in (7, 5, 3):
                _conv(spec, f"{ip}.c_layer_{kk}x{kk}", rc, rc, kk)
                _conv(spec, f"{ip}.v_layer_{kk}x1", rc, rc, (kk, 1))
                _conv(spec, f"{ip}.q_layer_1x{kk}", rc, rc, (1, kk))
            _conv(spec, f"{ip}.conv1x1_return_channel", rc, q, 1)
            _bn(spec, f"{ip}.bn", q)
        _head_spec(spec, nc, "large")
    else:
        raise ValueError(f"unknown preset: {preset}")
    return spec


def synthesize_thresh_defaults(
    state_dict: Dict[str, np.ndarray], preset: str, scale: float = 0.75,
) -> Dict[str, np.ndarray]:
    """Fill a pruned thresh branch with inference-neutral defaults.

    Paddle inference exports drop ``head.thresh.*`` (eval forward never runs
    it). The variable tree still has the branch, so synthesize zero kernels /
    identity BN stats — the inference output is unaffected.
    """
    spec = paddle_state_spec(preset, scale)
    out = dict(state_dict)
    for key, shape in spec.items():
        if key.startswith("head.thresh.") and key not in out:
            if key.endswith("._variance") or (
                    ".conv_bn" in key and key.endswith(".weight")):
                out[key] = np.ones(shape, np.float32)
            else:
                out[key] = np.zeros(shape, np.float32)
    return out


def convert_paddle_det_state_dict(
    state_dict: Mapping[str, np.ndarray], preset: str, scale: float = 0.75,
) -> Dict[str, object]:
    """Paddle structured state dict -> flax-layout variables for DBNet(preset).

    Accepts train-format key names; BN running stats may be spelled either
    ``_mean``/``_variance`` (paddle) or ``running_mean``/``running_var``.
    A missing thresh branch is synthesized (inference exports prune it).
    Unmapped keys raise.
    """
    normalized: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        if key.endswith("._mean"):
            key = key[: -len("._mean")] + ".running_mean"
        elif key.endswith("._variance"):
            key = key[: -len("._variance")] + ".running_var"
        normalized[key] = np.asarray(value)
    if not any(k.startswith("head.thresh.") for k in normalized):
        filled = synthesize_thresh_defaults(
            {k: v for k, v in state_dict.items()}, preset, scale)
        for key, value in filled.items():
            if key.startswith("head.thresh."):
                if key.endswith("._mean"):
                    key = key[: -len("._mean")] + ".running_mean"
                elif key.endswith("._variance"):
                    key = key[: -len("._variance")] + ".running_var"
                normalized[key] = value
    return convert_state_dict(normalized, DET_RULES[preset])


def validate_state_dict(state_dict: Mapping[str, np.ndarray], preset: str,
                        scale: float = 0.75) -> List[str]:
    """Key/shape diff of a checkpoint against the expected Paddle program."""
    spec = paddle_state_spec(preset, scale)
    problems = []
    for key, shape in spec.items():
        if key not in state_dict:
            if key.startswith("head.thresh."):
                continue  # optional (pruned by inference export)
            problems.append(f"missing: {key}")
        elif tuple(np.shape(state_dict[key])) != tuple(shape):
            problems.append(
                f"shape {key}: {tuple(np.shape(state_dict[key]))} != {shape}")
    for key in state_dict:
        if key not in spec:
            problems.append(f"unexpected: {key}")
    return problems


# ---------------------------------------------------------------------------
# Raw blob loading (needs the paddle package)
# ---------------------------------------------------------------------------


def load_pdiparams(path: str) -> Dict[str, np.ndarray]:
    """Load a Paddle inference .pdiparams blob into {structured_name: array}.

    Requires paddlepaddle: paddle.jit.load reads the program, and the
    .pdiparams.info sidecar maps program var names back to structured names.
    """
    try:
        import paddle  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "Paddle is required to parse .pdiparams blobs; install "
            "paddlepaddle, or export the trained .pdparams state dict and "
            "feed it to convert_paddle_det_state_dict directly."
        ) from e
    import paddle

    program = paddle.jit.load(path.rsplit(".", 1)[0])
    return {
        var.name: np.asarray(var.value().get_tensor())
        for var in program.parameters()
    }

