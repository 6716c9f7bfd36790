"""Spatial partitioning over the mesh's 'model' group (port of
automoe_tpu/parallel/sp.py: `--spatial --model-axis M`).

The ResNet-18 trunks run with the image height split over the M ranks of
a model group: rank m computes rows [m·H/M, (m+1)·H/M) of every map of
its data shard, while the batch stays split over 'data'. What a rank
keeps for the backward of the split maps falls to about 1/M; its peak
falls less, since the parameters, the optimizer state, the whole input,
the heads and the largest convolution workspace do not shrink with M
(`tools/sp_memory.py` measures both, whole against split). In JAX, GSPMD
writes the collectives; here they are written by hand:

  * each ResNet18Backbone is swapped for `SpatialResNet18Backbone`
    (`spatial_model`), which cuts its rows out of the whole image it is
    given (every rank of a model group holds its data shard's whole
    batch, so nothing else of the model changes: heads, resizes, losses,
    augmentation and the other image consumers see whole tensors);
  * every conv and max-pool of the trunk exchanges boundary rows with
    its neighbours (`Mesh.permute`, a ring shift whose backward rotates
    back). The rows above and below come from the layer's global row
    arithmetic: output row r reads input rows [r·s − p, r·s − p + k − 1],
    so with h rows a shard and h = (H_out / M)·s a rank needs p rows from
    the rank before and k − s − p from the rank after (7×7/s2/p3: 3 and
    2; 3×3/s2/p1: 1 and 0; 3×3/s1/p1: 1 and 1; 1×1/s2: 0 and none). The
    ring wraps: the first rank's rows from above and the last rank's rows
    from below are replaced by the layer's padding (0 for a conv, −inf
    for a max-pool), kept in the graph so that every rank runs every
    backward permute. The layer then runs with padding 0 along H and its
    own padding along W, and keeps for its backward the shard and the
    halo rows, not their concatenation (`_HaloConv`, `_HaloPool`);
  * BatchNorm of a split map takes its statistics over (B, H, W) across
    the whole world, data x model (parallel/batchnorm.py, group "world");
  * a map is gathered back to whole height (`Mesh.gather` over 'model'
    along H) before any layer whose output height would fall below
    `min_rows_per_shard · M` (JAX's `spatial_gather_interceptor`), or
    would not split evenly over M, or whose halo the neighbour cannot
    supply; GSPMD pads such shards, the port gathers instead (the
    outputs are the same). The trunk's output leaves whole.

Gradients need no rule of their own: the gather's backward sums the
gradient of the whole map over the model group (each rank holds the full
gradient of its own, equal, loss) and hands each rank its rows, so every
rank's gradient of the split part is M times its share and the world sum
that `Mesh.reduce_gradients` takes, divided by the world size, is the
gradient of the data group's mean loss, as for the whole parameters.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from automoe_tpu_torch.models.resnet import (
    BasicBlock,
    QATConv2d,
    ResNet18Backbone,
    _running_stats_frozen,
)
from automoe_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

#: batch fields split by height (NHWC dim 1), as in the JAX package
IMAGE_KEYS: Tuple[str, ...] = ("image",)


def check_spatial_batch(batch: Dict, mesh: Mesh, image_keys=IMAGE_KEYS) -> None:
    """JAX's `spatial_batch_shardings` check: every image field's height
    must divide by the 'model' axis."""
    model = mesh.shape[MODEL_AXIS]
    for k in image_keys:
        if k in batch:
            h = batch[k].shape[1]
            if h % model != 0:
                raise ValueError(f"spatial partitioning needs H ({h}) divisible by the "
                                 f"'model' axis ({model})")


class _Plan:
    """The halo arithmetic and the collectives of one model group."""

    def __init__(self, mesh: Mesh, min_rows_per_shard: int):
        self.mesh = mesh
        self.M = mesh.shape[MODEL_AXIS]
        self.m = mesh.model_index
        self.thresh = min_rows_per_shard * self.M

    def halo_rows(self, layer: nn.Module, h: int) -> Optional[Tuple[int, int, int]]:
        """(rows from the rank before, rows from the rank after, output
        rows a shard) of a conv or pool over shards of h rows; None when
        the layer must run on the whole map."""
        k, s, p = (_pair(layer.kernel_size)[0], _pair(layer.stride)[0],
                   _pair(layer.padding)[0])
        H_out = (h * self.M + 2 * p - k) // s + 1
        ho = H_out // self.M
        if H_out < self.thresh or H_out % self.M or h != ho * s:
            return None
        top, bottom = p, k - s - p
        if top > h or bottom > h:
            return None
        return top, max(bottom, 0), ho

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, h, W] shards → the whole [B, C, M·h, W] on every rank."""
        return torch.cat(self.mesh.gather(x, MODEL_AXIS).unbind(0), dim=2)

    def _edge(self, rows: torch.Tensor, shift: int, at_edge: bool, pad: float) -> torch.Tensor:
        got = self.mesh.permute(rows.contiguous(), shift, MODEL_AXIS)
        if at_edge:  # the wrapped rows become padding (still in the graph)
            got = torch.where(torch.zeros_like(got, dtype=torch.bool), got,
                              torch.full_like(got, pad))
        return got

    def halos(self, x: torch.Tensor, top: int, bottom: int, pad: float):
        """The `top` rows above x (from the rank before) and the `bottom`
        rows below it (from the rank after); zero rows when none."""
        none = x[:, :, :0]
        return (self._edge(x[:, :, -top:], 1, self.m == 0, pad) if top else none,
                self._edge(x[:, :, :bottom], -1, self.m == self.M - 1, pad) if bottom else none)

    def window(self, layer: nn.Module, x: torch.Tensor, split: bool, run_split,
               pad: float) -> Tuple[torch.Tensor, bool]:
        """A conv or pool over x: on the shards with their halo where the
        arithmetic allows it, else on the whole map."""
        rows = self.halo_rows(layer, x.shape[2]) if split else None
        if rows is None:
            return layer(self.gather(x) if split else x), False
        top, bottom, ho = rows
        y = run_split(x, *self.halos(x, top, bottom, pad))
        if y.shape[2] != ho:
            raise AssertionError(f"halo arithmetic: {y.shape[2]} rows, expected {ho}")
        return y, True

    def conv(self, conv: nn.Conv2d, x: torch.Tensor, split: bool):
        def run(x, top, bottom):
            w = conv.weight
            if isinstance(conv, QATConv2d):
                from automoe_tpu_torch.ops.fake_quant import fake_quant_weight

                w = fake_quant_weight(w)
            return _HaloConv.apply(x, top, bottom, w, conv.bias, _pair(conv.stride),
                                   _pair(conv.padding)[1], _pair(conv.dilation), conv.groups)

        return self.window(conv, x, split, run, 0.0)

    def pool(self, pool: nn.MaxPool2d, x: torch.Tensor, split: bool):
        def run(x, top, bottom):
            return _HaloPool.apply(x, top, bottom, _pair(pool.kernel_size), _pair(pool.stride),
                                   _pair(pool.padding)[1], _pair(pool.dilation),
                                   pool.ceil_mode)[0]

        return self.window(pool, x, split, run, float("-inf"))

    def norm(self, bn: nn.Module, x: torch.Tensor, split: bool) -> torch.Tensor:
        """BatchNorm with its statistics over the world for a split map,
        over the data group for a whole one."""
        if hasattr(bn, "_mesh"):
            bn._group = "world" if split else "data"
        return bn(x)

    def act_quant(self, x: torch.Tensor, split: bool) -> torch.Tensor:
        """QAT's per-tensor input fake-quant, its absmax over the model
        group for a split map."""
        from automoe_tpu_torch.ops.fake_quant import fake_quant_act

        if not split:
            return fake_quant_act(x)
        amax = self.mesh.all_gather(x.detach().float().abs().amax(), MODEL_AXIS).amax()
        return fake_quant_act(x, amax=amax)

    def block(self, block: BasicBlock, x: torch.Tensor, split: bool):
        fq = (lambda t, sp: self.act_quant(t, sp)) if block.qat else (lambda t, sp: t)
        xq = fq(x, split)
        y, s1 = self.conv(block.conv1, xq, split)
        y = torch.relu(self.norm(block.bn1, y, s1))
        y, s2 = self.conv(block.conv2, fq(y, s1), s1)
        y = self.norm(block.bn2, y, s2)
        r, sr = x, split
        if block.downsample is not None:
            r, sr = self.conv(block.downsample[0], xq, split)
            r = self.norm(block.downsample[1], r, sr)
        if s2 != sr:  # one branch ran whole: meet it whole
            y, r = (self.gather(y) if s2 else y), (self.gather(r) if sr else r)
        return torch.relu(y + r), s2 and sr

    def block_split(self, block: BasicBlock, h: int, split: bool) -> bool:
        """Whether `block` leaves a map of h rows a shard split (from the
        shapes alone, as `block` decides)."""
        first = self.halo_rows(block.conv1, h) if split else None
        if first is None or self.halo_rows(block.conv2, first[2]) is None:
            return False
        return block.downsample is None or self.halo_rows(block.downsample[0], h) is not None


def _pair(v):
    return v if isinstance(v, tuple) else (v, v)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the layer runs in: autocast's when it is on (as F.conv2d
    would cast), else x's."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


class _HaloConv(torch.autograd.Function):
    """conv2d over the rows [top; x; bottom] with padding (0, pw): the
    backward gets x and the halo rows, not their concatenation, which it
    builds again. x is the output of the ReLU or the pool before, which
    the autograd graph holds anyway, so a split conv adds only its halo
    rows to what the backward keeps (saving the concatenation would hold
    every split map twice)."""

    @staticmethod
    def forward(ctx, x, top, bottom, weight, bias, stride, pw, dilation, groups):
        dtype = _compute_dtype(x)
        with torch.autocast(x.device.type, enabled=False):
            y = F.conv2d(torch.cat([top, x, bottom], 2).to(dtype), weight.to(dtype),
                         None if bias is None else bias.to(dtype), stride, (0, pw), dilation,
                         groups)
        ctx.save_for_backward(x, top, bottom, weight)
        ctx.conf = dtype, stride, pw, dilation, groups, bias is not None
        return y

    @staticmethod
    def backward(ctx, gy):
        x, top, bottom, weight = ctx.saved_tensors
        dtype, stride, pw, dilation, groups, has_bias = ctx.conf
        need = ctx.needs_input_grad
        gxh, gw, gb = torch.ops.aten.convolution_backward(
            gy.to(dtype), torch.cat([top, x, bottom], 2).to(dtype), weight.to(dtype),
            [weight.shape[0]] if has_bias else None, list(stride), [0, pw], list(dilation),
            False, [0, 0], groups, [any(need[:3]), need[3], has_bias and need[4]])
        t, h = top.shape[2], x.shape[2]
        if gxh is not None:
            gxh = gxh.to(x.dtype)
            gx, gt, gbm = gxh[:, :, t:t + h], gxh[:, :, :t], gxh[:, :, t + h:]
        else:
            gx = gt = gbm = None
        return (gx, gt, gbm, None if gw is None else gw.to(weight.dtype),
                None if gb is None else gb.to(weight.dtype), None, None, None, None)


class _HaloPool(torch.autograd.Function):
    """max_pool2d over the rows [top; x; bottom] with padding (0, pw),
    keeping for the backward x, the halo rows and the argmax indices (as
    the plain pool keeps its input and indices), not the concatenation."""

    @staticmethod
    def forward(ctx, x, top, bottom, kernel, stride, pw, dilation, ceil_mode):
        y, idx = torch.ops.aten.max_pool2d_with_indices(
            torch.cat([top, x, bottom], 2), list(kernel), list(stride), [0, pw],
            list(dilation), ceil_mode)
        ctx.save_for_backward(x, top, bottom, idx)
        ctx.conf = kernel, stride, pw, dilation, ceil_mode
        ctx.mark_non_differentiable(idx)
        return y, idx

    @staticmethod
    def backward(ctx, gy, _gidx):
        x, top, bottom, idx = ctx.saved_tensors
        kernel, stride, pw, dilation, ceil_mode = ctx.conf
        gxh = torch.ops.aten.max_pool2d_with_indices_backward(
            gy, torch.cat([top, x, bottom], 2), list(kernel), list(stride), [0, pw],
            list(dilation), ceil_mode, idx)
        t, h = top.shape[2], x.shape[2]
        return (gxh[:, :, t:t + h], gxh[:, :, :t], gxh[:, :, t + h:], None, None, None, None,
                None)


class SpatialResNet18Backbone(ResNet18Backbone):
    """ResNet18Backbone whose maps are split by height over the model
    group (module docstring). Its input is the whole image; its output is
    whole."""

    _sp: _Plan

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = self._sp
        H = x.shape[2]
        if H % sp.M:
            raise ValueError(f"spatial partitioning needs H ({H}) divisible by the 'model' "
                             f"axis ({sp.M})")
        h = H // sp.M
        x = x[:, :, sp.m * h:(sp.m + 1) * h]
        children = list(self)
        x, split = sp.conv(children[0], x, True)
        x = children[2](sp.norm(children[1], x, split))
        x, split = sp.pool(children[3], x, split)
        remat = self.remat and torch.is_grad_enabled()
        for layer in children[4:]:
            for block in layer:
                if remat:
                    out_split = sp.block_split(block, x.shape[2], split)
                    x = torch.utils.checkpoint.checkpoint(
                        lambda t, b=block, s=split: sp.block(b, t, s)[0], x,
                        use_reentrant=False, preserve_rng_state=True,
                        context_fn=lambda b=block: (contextlib.nullcontext(),
                                                    _running_stats_frozen(b)))
                    split = out_split
                else:
                    x, split = sp.block(block, x, split)
        if split:
            x = sp.gather(x)
        if self.include_pool:
            x = x.mean(dim=(2, 3))
        return x


def spatial_model(model: nn.Module, mesh: Mesh, min_rows_per_shard: int = 4) -> int:
    """Split every ResNet-18 trunk of `model` by height over the mesh's
    model group, in place (the state dict is unchanged). Returns how many
    trunks. `min_rows_per_shard` must be >= 1."""
    if min_rows_per_shard < 1:
        raise ValueError("min_rows_per_shard must be >= 1 (padded spatial shards "
                         "miscompile the backward)")
    plan = _Plan(mesh, min_rows_per_shard)
    n = 0
    for m in model.modules():
        if type(m) is ResNet18Backbone:
            m.__class__ = SpatialResNet18Backbone
            m._sp = plan
            n += 1
    return n
