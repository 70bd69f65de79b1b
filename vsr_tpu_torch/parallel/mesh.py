"""Inference meshes: one model replica per device.

The port's counterpart of ``vsr_tpu/parallel/mesh.py`` for inference. A mesh
here is an ordered list of ``torch.device``s. The inpainters shard their
embarrassingly parallel axis over it — STTN's windows, LaMa's band-batch
frames, ProPainter's windows — and run each shard on a copy of the model
on its device; inputs are gathered on the first device and copied to each
replica, predictions come back to the first device (or the host), and every
order-dependent step (the overlap composites) stays on the first device.
Inference needs no collective, so there is no process group and no GSPMD:
the JAX package's ``param_sharding_rules`` / ``shard_params`` (tensor
parallelism) serve training only and come with it.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from vsr_tpu_torch.utils.device import resolve_device

Mesh = List[torch.device]


def create_mesh(devices: Optional[Sequence[Union[str, torch.device]]] = None,
                data: Optional[int] = None, model: int = 1) -> Mesh:
    """The given devices (default: every visible CUDA device) as a mesh of
    ``data`` replicas. ``model`` must be 1: tensor parallelism is training's.
    Every entry has the first one's type; a CUDA entry without an index is
    the current device."""
    if model != 1:
        raise ValueError(f"inference meshes are replicas only (model=1), got model={model}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if any(d.type != devices[0].type for d in devices):
        raise ValueError(f"mixed device types in mesh {[str(d) for d in devices]}")
    if data is not None and data != len(devices):
        raise ValueError(f"mesh of {data} replicas over {len(devices)} devices")
    return [resolve_device(d) for d in devices]


def default_inference_mesh(device: Union[str, torch.device]) -> Optional[Mesh]:
    """Every visible CUDA device when the caller asked for ``"cuda"`` with no
    index and more than one card is visible; otherwise None, so ``cuda:0``
    pins one card and a CPU run is never sharded by default."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available() \
            and torch.cuda.device_count() > 1:
        return create_mesh()
    return None


def replicate(module: nn.Module, mesh: Sequence[Union[str, torch.device]]) -> List[nn.Module]:
    """One replica of ``module`` per mesh entry: the module itself on its own
    device, one deep copy for each other device (entries that repeat a
    device share one replica). The mesh's devices must have the module's
    device type."""
    mesh = create_mesh(mesh)
    home = next(module.parameters()).device
    if mesh[0].type != home.type:
        raise ValueError(f"mesh on {mesh[0].type} for a model on {home}")
    copies = {home: module}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = copy.deepcopy(module).to(dev)
    return [copies[dev] for dev in mesh]

