"""BatchNorm over the data group's global batch (or over the world for a
height-split map: parallel/sp.py).

The JAX package's data mesh computes BatchNorm statistics over the global
batch: GSPMD turns the mean over a sharded batch axis into an all-reduce.
Plain per-rank BatchNorm would normalise each rank's rows alone, and
`torch.nn.SyncBatchNorm` runs on CUDA tensors only, so the port has its
own: `convert_batchnorm` swaps every BatchNorm1d/2d of a model for a
subclass whose train-mode forward is `_CrossRankNorm`:

  forward   each rank's (count, mean, M2) per channel, all-gathered over
            the group and combined exactly (Chan's parallel variance),
            then y = (x - mean) / sqrt(var + eps) * weight + bias;
  backward  Σ dy and Σ dy·x̂ all-reduced over the group, so the input
            gradient is the transpose of the global normalisation; the
            affine gradients stay local (the step sums them over ranks).

Running statistics follow torch's convention at the global count:
running_var takes the unbiased variance var · n / (n - 1), n the rows of
the whole data group, with the module's own momentum (so the remat
recomputation's momentum 0 leaves them put). Eval mode and a data group
of one use torch's BatchNorm unchanged. GroupNorm (the deep trunk) is per
sample and needs nothing.
"""
from __future__ import annotations

import torch
from torch import nn

from automoe_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


class _CrossRankNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, mesh: Mesh, group: str):
        dims = [0] + list(range(2, x.ndim))
        xf = x.float()
        n_local = xf.numel() // xf.shape[1]
        var_l, mean_l = torch.var_mean(xf, dim=dims, unbiased=False)
        local = torch.cat([torch.full_like(mean_l[:1], float(n_local)), mean_l,
                           var_l * n_local])
        allst = mesh.all_gather(local, group)  # [D, 1 + 2C]
        C = mean_l.numel()
        counts, means, m2s = allst[:, :1], allst[:, 1:C + 1], allst[:, C + 1:]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (m2s.sum(0) + (counts * (means - mean) ** 2).sum(0)) / n
        invstd = torch.rsqrt(var + eps)
        shape = [1, -1] + [1] * (x.ndim - 2)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = y * weight.float().view(shape) + bias.float().view(shape)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.mesh, ctx.group, ctx.n, ctx.shape, ctx.dims = mesh, group, n, shape, dims
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dn):
        xhat, invstd, weight = ctx.saved_tensors
        shape, dims = ctx.shape, ctx.dims
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * xhat).sum(dims)
        both = ctx.mesh.all_reduce(torch.cat([sum_dy, sum_dy_xhat]), ctx.group)
        C = sum_dy.numel()
        g_sum, g_sum_xhat = both[:C] / ctx.n, both[C:] / ctx.n
        scale = invstd if weight is None else invstd * weight.float()
        dx = scale.view(shape) * (dyf - g_sum.view(shape) - xhat * g_sum_xhat.view(shape))
        dw = db = None
        if weight is not None:
            dw, db = sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype)
        return dx.to(dy.dtype), dw, db, None, None, None


class _CrossRankMixin:
    """forward of a BatchNorm whose train-mode statistics span the group
    `self._group` of `self._mesh` ("data" unless the caller sets it:
    spatial partitioning normalises a height-split map over "world")."""

    _mesh: Mesh
    _group: str = DATA_AXIS

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self._mesh.group_size(self._group) == 1:
            return super().forward(x)
        self._check_input_dim(x)
        y, mean, var, n = _CrossRankNorm.apply(x, self.weight, self.bias, self.eps,
                                               self._mesh, self._group)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                     else self.momentum)
                unbiased = var * (n / torch.clamp(n - 1, min=1))
                self.running_mean.mul_(1 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased.to(self.running_var.dtype),
                                                  alpha=m)
        return y


class CrossRankBatchNorm1d(_CrossRankMixin, nn.BatchNorm1d):
    pass


class CrossRankBatchNorm2d(_CrossRankMixin, nn.BatchNorm2d):
    pass


_CROSS = {nn.BatchNorm1d: CrossRankBatchNorm1d, nn.BatchNorm2d: CrossRankBatchNorm2d}


def convert_batchnorm(model: nn.Module, mesh: Mesh) -> int:
    """Make every BatchNorm1d/2d under `model` normalise over the data
    group of `mesh` in train mode (in place: the modules keep their
    parameters, buffers and state-dict names). Returns how many."""
    n = 0
    for m in model.modules():
        cls = _CROSS.get(type(m))
        if cls is not None:
            m.__class__ = cls
            m._mesh = mesh
            n += 1
    return n

