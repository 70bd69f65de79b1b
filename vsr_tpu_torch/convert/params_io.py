"""Flat npz persistence for flax-layout param trees, in numpy.

A copy of ``vsr_tpu/convert/params_io.py`` without jax: the same format
(``np.savez`` of '/'-joined paths), so a models directory written by either
package loads in both.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from vsr_tpu_torch.convert.mapping import as_leaf, flatten_tree, unflatten_tree


def save_params(path: str, params: Dict[str, Any]) -> None:
    flat = flatten_tree(params)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_params(path: str) -> Dict[str, Any]:
    with np.load(path) as data:
        flat = {k: as_leaf(data[k]) for k in data.files}
    return unflatten_tree(flat)
