"""Generic torch-state-dict -> flax-params mapping engine, in numpy.

A copy of ``vsr_tpu/convert/mapping.py`` without jax: the same rules give
the same ``{'params': ..., 'batch_stats': ...}`` tree, with numpy leaves,
so a ``.npz`` written by either package loads in both.

Each model ships a table of (regex over torch module path -> flax path
template) plus a layer kind that fixes the tensor layout conversion:

  conv2d          weight OIHW  -> kernel HWIO
  conv3d          weight OIDHW -> kernel DHWIO
  convtranspose2d weight (I, O, kh, kw) -> kernel (kh, kw, O, I)
  linear          weight OI    -> kernel IO
  layernorm       weight/bias  -> scale/bias
  batchnorm       weight/bias/running_mean/running_var -> scale/bias (+batch_stats)
  affine          bare scale/bias pair (paddle LearnableAffineBlock)
  deform_kernel   a deform conv's own weight -> bare "kernel" param, HWIO
  depthwise2d     (C, 1, kh, kw) -> [kh, kw, 1, C] under the template's name

convert_state_dict() walks the state dict, applies the first matching rule,
and builds the variable tree. Unmatched keys raise (or are dropped, with
strict=False) so silent drops can't happen.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

Rule = Tuple[str, str, str]  # (regex, flax path template, kind)

# what jnp.asarray makes of a 64-bit array while JAX's x64 mode is off (its
# default): the JAX package's trees, and so its .npz files, hold these
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def as_leaf(value) -> np.ndarray:
    """A tree leaf as the JAX package stores it: a copy, 64-bit types
    narrowed to 32 bits."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    return np.array(arr, dtype=_NARROW.get(arr.dtype, arr.dtype))


def flatten_tree(tree: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}, depth first in insertion order; empty
    dicts vanish (flax.traverse_util.flatten_dict's defaults)."""
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            for sub, leaf in flatten_tree(value, sep).items():
                flat[f"{key}{sep}{sub}"] = leaf
        else:
            flat[key] = value
    return flat


def unflatten_tree(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """The inverse of flatten_tree."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, name = path.split(sep)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[name] = leaf
    return tree


def convert_state_dict(
    state_dict: Mapping[str, Any],
    rules: Sequence[Rule],
    strict: bool = True,
) -> Dict[str, Any]:
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    unmatched: List[str] = []

    compiled = [(re.compile(rx), tmpl, kind) for rx, tmpl, kind in rules]

    for key, value in state_dict.items():
        module_path, leaf = key.rsplit(".", 1)
        if leaf in ("num_batches_tracked",):
            continue
        hit = None
        for rx, tmpl, kind in compiled:
            m = rx.fullmatch(module_path)
            if m:
                hit = (m.expand(tmpl), kind)
                break
        if hit is None:
            unmatched.append(key)
            continue
        flax_path, kind = hit
        arr = as_leaf(value)
        if kind in ("conv2d", "convtranspose2d", "deform_kernel"):
            # a ConvTranspose2d's (I, O, kh, kw) -> (kh, kw, O, I) is the
            # same axis permutation (flax transpose_kernel=True)
            if leaf == "weight":
                params[f"{flax_path}/kernel"] = arr.transpose(2, 3, 1, 0)
            else:
                params[f"{flax_path}/bias"] = arr
        elif kind == "conv3d":
            if leaf == "weight":
                params[f"{flax_path}/kernel"] = arr.transpose(2, 3, 4, 1, 0)
            else:
                params[f"{flax_path}/bias"] = arr
        elif kind == "linear":
            if leaf == "weight":
                params[f"{flax_path}/kernel"] = arr.T
            else:
                params[f"{flax_path}/bias"] = arr
        elif kind == "layernorm":
            name = "scale" if leaf == "weight" else "bias"
            params[f"{flax_path}/{name}"] = arr
        elif kind == "batchnorm":
            if leaf == "weight":
                params[f"{flax_path}/scale"] = arr
            elif leaf == "bias":
                params[f"{flax_path}/bias"] = arr
            elif leaf == "running_mean":
                stats[f"{flax_path}/mean"] = arr
            elif leaf == "running_var":
                stats[f"{flax_path}/var"] = arr
        elif kind == "affine":
            params[f"{flax_path}/{leaf}"] = arr
        elif kind == "depthwise2d":
            if leaf == "weight":
                params[f"{flax_path}"] = arr.transpose(2, 3, 1, 0)
            else:
                params[f"{flax_path.rsplit('/', 1)[0]}/pool_bias"] = arr
        else:
            raise ValueError(f"unknown mapping kind: {kind}")

    if unmatched and strict:
        raise KeyError(f"unmapped checkpoint keys: {unmatched[:8]}"
                       f"{'...' if len(unmatched) > 8 else ''}")

    out: Dict[str, Any] = {"params": unflatten_tree(params)}
    if stats:
        out["batch_stats"] = unflatten_tree(stats)
    return out


def validate_against(variables: Dict[str, Any], reference: Dict[str, Any]) -> List[str]:
    """Compare a converted tree to a reference tree; returns mismatch list."""
    flat_a = flatten_tree(variables)
    flat_b = flatten_tree(reference)
    problems = []
    for k in sorted(set(flat_a) | set(flat_b)):
        if k not in flat_a:
            problems.append(f"missing: {k}")
        elif k not in flat_b:
            problems.append(f"extra: {k}")
        elif tuple(np.shape(flat_a[k])) != tuple(np.shape(flat_b[k])):
            problems.append(
                f"shape {k}: {tuple(np.shape(flat_a[k]))} != {tuple(np.shape(flat_b[k]))}")
    return problems
