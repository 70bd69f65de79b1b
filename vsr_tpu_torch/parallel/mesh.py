"""Meshes for inference and for training: the port's counterpart of
``vsr_tpu/parallel/mesh.py``. Both halves live here.

Inference: a mesh is an ordered list of ``torch.device``s, one model replica
per device. The inpainters shard their embarrassingly parallel axis over
it — STTN's windows, LaMa's band-batch frames, ProPainter's windows — and
run each shard on a copy of the model on its device; inputs are gathered on
the first device and copied to each replica, predictions come back to the
first device (or the host), and every order-dependent step (the overlap
composites) stays on the first device. Inference needs no collective, so
there is no process group.

Training: a ``parallel.distributed.TrainingMesh`` of process groups, one
process per device. Data parallelism lives there; tensor parallelism lives
here: ``param_sharding_rules`` and ``shard_params`` split a Conv2d's output
channels over the model group (the JAX package's HWIO kernel axis O, torch's
weight dim 0, with its bias) as column-parallel convolutions. JAX lets
GSPMD insert the collectives; here two autograd functions do: the input's
identity whose gradient is summed over the model group, and the gather of
the output's channel slices, whose gradient is this rank's slice.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
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



# ---- training: tensor parallelism over a TrainingMesh's model group ----


def _gather_channels(t: torch.Tensor, group, index: int, size: int, dim: int) -> torch.Tensor:
    """This rank's slice of dim ``dim`` put in place in a zero-filled full
    tensor, summed over the group: the all-gather as an all_reduce, exact
    (every element is one rank's value plus zeros)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * size
    full = t.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(t)
    dist.all_reduce(full, group=group)
    return full


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (each
    rank's slice of the output channels contributes its part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The output channels' slices gathered forward; this rank's slice of
    the gradient backward."""

    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.index, ctx.n = index, y.shape[1]
        return _gather_channels(y, group, index, size, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None


class ColumnParallelConv2d(nn.Module):
    """A Conv2d whose output channels are split over a model group: this
    rank holds ``weight[index * o:(index + 1) * o]`` (and the bias slice) and
    returns the full output. Its state dict holds the full tensors: saving
    gathers them (a collective, so every rank of the group calls
    ``state_dict``) and loading takes this rank's slice of full tensors."""

    def __init__(self, conv: nn.Conv2d, group, index: int, size: int):
        super().__init__()
        o = conv.out_channels // size
        self.group, self.index, self.size = group, index, size
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.weight = nn.Parameter(conv.weight.detach()[index * o:(index + 1) * o].clone())
        self.bias = None if conv.bias is None else nn.Parameter(
            conv.bias.detach()[index * o:(index + 1) * o].clone())
        for p in self.parameters():
            p.model_shard = (group, index, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.group)
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation)
        return _GatherFromModel.apply(y, self.group, self.index, self.size)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        for name, p in self.named_parameters(recurse=False):
            destination[prefix + name] = _gather_channels(
                p.detach(), self.group, self.index, self.size, dim=0)

    def _load_from_state_dict(self, state_dict, prefix, *args):
        for name, p in self.named_parameters(recurse=False):
            key = prefix + name
            if key in state_dict and state_dict[key].shape[0] == p.shape[0] * self.size:
                state_dict[key] = state_dict[key].narrow(0, self.index * p.shape[0], p.shape[0])
        super()._load_from_state_dict(state_dict, prefix, *args)


def param_sharding_rules(module: nn.Module, model: int) -> Optional[int]:
    """The dim of ``module``'s parameters to split over ``model`` ranks, or
    None to replicate them: a plain Conv2d's output channels (weight dim 0,
    the JAX package's HWIO axis O, with its bias) when they divide; anything
    else (5-D Conv3d kernels, norms, Linear layers, grouped convs)
    replicated, as JAX falls back when a split does not divide."""
    if (type(module) is nn.Conv2d and module.groups == 1 and module.padding_mode == "zeros"
            and module.out_channels % model == 0):
        return 0
    return None


def shard_params(module: nn.Module, mesh) -> List[str]:
    """Replace each Conv2d of ``module`` that ``param_sharding_rules``
    splits by a ColumnParallelConv2d over ``mesh``'s model group (every rank
    of the group calls this on an identical module); returns the replaced
    modules' names. A mesh with one model rank changes nothing."""
    if mesh.model == 1:
        return []
    sharded = []
    for name, parent in list(module.named_modules()):
        for child_name, child in list(parent.named_children()):
            if param_sharding_rules(child, mesh.model) is not None:
                setattr(parent, child_name, ColumnParallelConv2d(
                    child, mesh.model_group, mesh.model_index, mesh.model))
                sharded.append(f"{name}.{child_name}" if name else child_name)
    return sharded


def optimizer_state_dict(opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """``opt.state_dict()`` with the state of every model-sharded parameter
    (its moments) gathered to full size (a collective over its group)."""
    state = opt.state_dict()
    for idx, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        shard = getattr(p, "model_shard", None)
        if shard is not None and idx in state["state"]:
            state["state"][idx] = {
                k: _gather_channels(v, *shard, dim=0) if v.shape == p.shape else v
                for k, v in state["state"][idx].items()}
    return state


def load_optimizer_state_dict(opt: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
    """``opt.load_state_dict`` of a state that ``optimizer_state_dict``
    wrote, each model-sharded parameter's moments cut to this rank's slice."""
    for idx, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        shard = getattr(p, "model_shard", None)
        if shard is not None and idx in state["state"]:
            _, index, size = shard
            n = p.shape[0]
            state["state"][idx] = {
                k: v.narrow(0, index * n, n) if v.dim() and v.shape[0] == n * size else v
                for k, v in state["state"][idx].items()}
    opt.load_state_dict(state)
