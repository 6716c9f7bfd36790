"""Tensor parallelism over the mesh's 'model' group (port of
automoe_tpu/parallel/tp.py: `--tp-min-dim N --model-axis M`).

The rule is the JAX package's `_leaf_spec`: a parameter is split over
'model' when its rank is at least 2, its output dim is at least `min_dim`
and divides by M, and M > 1. JAX keeps the output dim last (HWIO conv
kernels, (in, out) Dense kernels, the deep trunk's [L, 3, 3, I, O]
stacks and [L, 1, 1, 1, C] GroupNorm affines, its stem's [1, 1, C]
GroupNorm affines, [Q, D] query tables); the port keeps the reference
layouts, so the dim that is split is the one holding JAX's last dim
(`jax_last_dim`): dim 0 of a Conv1d/Conv2d/Linear weight (OIHW, [O, I, 1],
[out, in]) and of a GroupNorm affine, dim 1 of the deep trunk's stacks,
the last dim of an embedding table. Biases and the other norms' affines
(1-D in both) stay whole.

Each model rank holds the slice m of the split dim (`tp_shard_state`, in
place, before the optimizer exists: its moments and EMA take the slices'
shapes, as JAX's moments share the kernels' sharding):

  * a Conv1d/Conv2d/Linear whose weight is split runs column-parallel: it
    computes its slice of output channels, the slices are gathered along
    the channel dim with `Mesh.gather(..., "model")`, and the whole bias
    is added after the gather;
  * any other split parameter (the deep trunk's stacks, a query table
    read as `.weight`) is gathered whole when the outermost running
    module that holds it starts its forward (the root, or a submodule
    called on its own) and put back when that forward ends.

Gradients need no rule of their own: the gather's backward sums the
gradient over the model group and hands each rank its slice, and the
optimizer reduces the slice over the data group and counts its square
once per model group (`Mesh.reduce_gradients` / `grad_norm_sq` with the
split names as stage-local, as a pipeline stage's are).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from automoe_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh


def jax_last_dim(module: nn.Module, name: str, p: torch.Tensor) -> Optional[int]:
    """The dim of the port's parameter `module.<name>` that holds the JAX
    package's last dim, None for a parameter of rank < 2 there."""
    from automoe_tpu_torch.models.deep_policy import StackedTrunk

    if isinstance(module, nn.GroupNorm):  # JAX keeps its affines [1, 1, C]
        return 0
    if p.ndim < 2:
        return None
    if name == "weight" and isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
        return 0
    if isinstance(module, StackedTrunk):
        return 1
    return p.ndim - 1


def tp_param_dims(model: nn.Module, model_size: int, min_dim: int) -> Dict[str, int]:
    """name → split dim of every parameter the JAX rule shards over a
    'model' axis of `model_size` at `min_dim`."""
    out: Dict[str, int] = {}
    if model_size <= 1:
        return out
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            d = jax_last_dim(module, pname, p)
            if d is not None and p.shape[d] >= min_dim and p.shape[d] % model_size == 0:
                out[f"{mname}.{pname}" if mname else pname] = d
    return out


def tp_param_names(model: nn.Module, model_size: int, min_dim: int) -> List[str]:
    return sorted(tp_param_dims(model, model_size, min_dim))


def _gather_dim(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model group's slices of x, concatenated along `dim` in rank
    order (autograd-aware)."""
    return torch.cat(mesh.gather(x, MODEL_AXIS).unbind(0), dim=dim)


class _ColumnParallel:
    """forward of a Conv1d/Conv2d/Linear holding its slice of output
    channels (mixed in ahead of the module's class)."""

    _tp_mesh: Mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from automoe_tpu_torch.models.resnet import QATConv2d
        from automoe_tpu_torch.ops.fake_quant import fake_quant_weight

        if isinstance(self, nn.Linear):
            y = _gather_dim(F.linear(x, self.weight), self._tp_mesh, -1)
            return y if self.bias is None else y + self.bias
        w = fake_quant_weight(self.weight) if isinstance(self, QATConv2d) else self.weight
        y = _gather_dim(self._conv_forward(x, w, None), self._tp_mesh, 1)
        if self.bias is None:
            return y
        return y + self.bias.view(1, -1, *([1] * (y.ndim - 2)))


_COLUMN: Dict[type, type] = {}


def _column_class(cls: type) -> type:
    if cls not in _COLUMN:
        _COLUMN[cls] = type(f"ColumnParallel{cls.__name__}", (_ColumnParallel, cls), {})
    return _COLUMN[cls]


class _Whole:
    """A split parameter that no column-parallel layer computes with: it is
    gathered whole when the outermost module holding it (its owner or any
    ancestor, so that a submodule called on its own, as the feature cache
    calls each expert, sees it whole too) starts its forward, and its
    slice is put back when that forward ends."""

    def __init__(self, module: nn.Module, pname: str, dim: int, mesh: Mesh):
        self.module, self.pname, self.dim, self.mesh = module, pname, dim, mesh
        self.param = module._parameters[pname]
        self.depth = 0

    def enter(self) -> None:
        if self.depth == 0:
            self.module._parameters[self.pname] = _gather_dim(self.param, self.mesh, self.dim)
        self.depth += 1

    def exit(self) -> None:
        self.depth -= 1
        if self.depth == 0:
            self.module._parameters[self.pname] = self.param


def _enter(entries: List[_Whole], module: nn.Module, args) -> None:
    for e in entries:
        e.enter()


def _exit(entries: List[_Whole], module: nn.Module, args, out) -> None:
    for e in entries:
        e.exit()


def tp_shard_state(model: nn.Module, mesh: Mesh, *, min_dim: int = 512) -> Dict[str, int]:
    """Cut every parameter the rule selects to this rank's slice, in place
    (the Parameter objects stay), and make the model compute with the
    slices (module docstring). Returns name → split dim."""
    dims = tp_param_dims(model, mesh.shape[MODEL_AXIS], min_dim)
    M, m = mesh.shape[MODEL_AXIS], mesh.model_index
    modules = dict(model.named_modules())
    hooked: Dict[int, tuple] = {}  # id → (module, the _Whole entries under it)
    for name, d in dims.items():
        mname, _, pname = name.rpartition(".")
        module = modules[mname]
        p = getattr(module, pname)
        p.data = p.detach().chunk(M, dim=d)[m].clone()
        if d == 0 and pname == "weight" and isinstance(module, (nn.Conv1d, nn.Conv2d,
                                                                nn.Linear)):
            module.__class__ = _column_class(type(module))
            module._tp_mesh = mesh
            continue
        entry = _Whole(module, pname, d, mesh)
        parts = mname.split(".") if mname else []
        for i in range(len(parts) + 1):  # the root, each ancestor, the owner
            holder = modules[".".join(parts[:i])]
            hooked.setdefault(id(holder), (holder, []))[1].append(entry)
    for holder, entries in hooked.values():
        holder.register_forward_pre_hook(functools.partial(_enter, entries))
        holder.register_forward_hook(functools.partial(_exit, entries), always_call=True)
    return dims


@contextlib.contextmanager
def unsharded(model: nn.Module, mesh: Mesh, dims: Dict[str, int]) -> Iterator[None]:
    """The split parameters whole (gathered over the model group, a
    collective) for the block: to load weights into them by name
    (`load_expert_checkpoints`) or to fingerprint them. This rank's slice
    of whatever they hold after the block is put back."""
    if not dims:
        yield
        return
    M, m = mesh.shape[MODEL_AXIS], mesh.model_index
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, d in dims.items():
            p = params[name]
            p.data = _gather_dim(p.detach(), mesh, d)
    try:
        yield
    finally:
        with torch.no_grad():
            for name, d in dims.items():
                p = params[name]
                p.data = p.detach().chunk(M, dim=d)[m].clone()
