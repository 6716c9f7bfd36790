"""Deep trajectory policy (port of automoe_tpu/models/deep_policy.py):
the policy's depth-scalable trunk, NCHW.

The same stem → trunk → pooled-head shape as `models/policy.py::
TrajectoryPolicy`, with EasyBackbone's 4 BatchNorm convs swapped for a
stride-4 5x5 stem + GroupNorm + ReLU, then `depth` identical
pre-activation residual blocks `h + conv(relu(gn(conv(relu(gn(h))))))`
with bias-free 3x3 SAME convs, then the mean pool, `fc` and the heads.

The trunk's parameters stay stacked on a leading [L] axis under the
submodule `pipeline_blocks` (conv1 / conv2 [L,C,C,3,3], the GroupNorm
affines [L,C]) and run as a loop over that axis (`sequential_apply`,
the counterpart of the JAX package's `lax.scan`); a pipeline can split
the stack by stage without reshaping any weight.

GroupNorm normalises each sample's groups alone (biased variance, eps
1e-5), which is `torch.nn.functional.group_norm`; under bf16 autocast it
runs in float32, where the JAX package casts its parameters to bf16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from automoe_tpu_torch.models.policy import _Head

#: the submodule (and state-dict prefix) of the [L]-stacked trunk
PIPELINE_BLOCKS = "pipeline_blocks"

#: std of a unit normal truncated to ±2 (flax's truncated_normal variance_scaling)
_TRUNC_STD = 0.87962566103423978


def group_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NCHW with a per-channel affine (scale, bias [C])."""
    return F.group_norm(h, groups, scale, bias, eps)


def residual_block(params: Dict[str, torch.Tensor], h: torch.Tensor, *,
                   groups: int) -> torch.Tensor:
    """One trunk block on one block's slice of the stacked parameters."""
    y = F.relu(group_norm(h, params["gn1_scale"], params["gn1_bias"], groups))
    y = F.conv2d(y, params["conv1"], padding=1)
    y = F.relu(group_norm(y, params["gn2_scale"], params["gn2_bias"], groups))
    y = F.conv2d(y, params["conv2"], padding=1)
    return h + y


def sequential_apply(block_fn: Callable, stacked: Dict[str, torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """The L blocks in a row: block l reads slice l of every stacked leaf."""
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        x = block_fn({k: v[i] for k, v in stacked.items()}, x)
    return x


class StackedTrunk(nn.Module):
    """The [L]-stacked block parameters and their sequential application."""

    def __init__(self, depth: int, width: int, groups: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        L, C = depth, width
        self.groups = groups
        self.conv1 = nn.Parameter(torch.empty(L, C, C, 3, 3, **fk))
        self.conv2 = nn.Parameter(torch.empty(L, C, C, 3, 3, **fk))
        self.gn1_scale = nn.Parameter(torch.ones(L, C, **fk))
        self.gn1_bias = nn.Parameter(torch.zeros(L, C, **fk))
        self.gn2_scale = nn.Parameter(torch.ones(L, C, **fk))
        self.gn2_bias = nn.Parameter(torch.zeros(L, C, **fk))
        self.seeded_init(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def seeded_init(self, generator: torch.Generator) -> None:
        """He-normal, truncated at ±2 std, on each block's own fan (9·C):
        drawn on the stacked shape's fan it would undershoot the variance
        by L. GroupNorm scales 1, biases 0."""
        for w in (self.conv1, self.conv2):
            std = math.sqrt(2.0 / w[0, 0].numel()) / _TRUNC_STD
            draw = torch.empty(w.shape)
            nn.init.trunc_normal_(draw, std=std, a=-2 * std, b=2 * std, generator=generator)
            w.copy_(draw)
        for p in (self.gn1_scale, self.gn2_scale):
            p.fill_(1.0)
        for p in (self.gn1_bias, self.gn2_bias):
            p.zero_()

    def stacked(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in
                ("conv1", "conv2", "gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")}

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        def block(p, x):
            return residual_block(p, x, groups=self.groups)

        return sequential_apply(block, self.stacked(), h)


class DeepTrajectoryPolicy(nn.Module):
    """TrajectoryPolicy with the deep trunk: image NCHW [+ context] →
    {"waypoints" [B,H,2], "speed" [B,H]}."""

    def __init__(self, horizon: int = 8, context_dim: int = 0, backbone_dim: int = 512,
                 depth: int = 16, width: int = 128, groups: int = 8, stem_stride: int = 4, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.horizon = horizon
        self.stem_conv = nn.Conv2d(3, width, 5, stem_stride, 2, bias=False, **fk)
        self.stem_gn = nn.GroupNorm(groups, width, eps=1e-5, **fk)
        setattr(self, PIPELINE_BLOCKS, StackedTrunk(depth, width, groups, **fk))
        self.fc = nn.Linear(width, backbone_dim, **fk)
        self.head_wp = _Head(backbone_dim + context_dim, horizon * 2, **fk)
        self.head_spd = _Head(backbone_dim + context_dim, horizon, **fk)

    def forward(self, image: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        h = F.relu(self.stem_gn(self.stem_conv(image)))
        h = getattr(self, PIPELINE_BLOCKS)(h)
        feat = self.fc(h.mean(dim=(2, 3)))
        x = feat if context is None else torch.cat([feat, context], dim=-1)
        return {
            "waypoints": self.head_wp(x).reshape(-1, self.horizon, 2),
            "speed": self.head_spd(x).reshape(-1, self.horizon),
        }


def trunk_flops_per_sample(depth: int, width: int, hw: int) -> float:
    """The trunk's forward FLOPs per sample: 2 convs of 3x3xCxC per block
    over an hw x hw map, 2 FLOPs a multiply-add."""
    return 2.0 * depth * 2 * (hw * hw) * 9 * width * width


__all__ = [
    "DeepTrajectoryPolicy",
    "PIPELINE_BLOCKS",
    "StackedTrunk",
    "group_norm",
    "residual_block",
    "sequential_apply",
    "trunk_flops_per_sample",
]
