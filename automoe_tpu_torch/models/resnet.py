"""ResNet-18 backbone (port of automoe_tpu/models/resnet.py), NCHW.

Structurally torchvision's resnet18 as the reference experts consume it:
`children()[:-2]` → [B,512,H/32,W/32], or with `include_pool` the global
average pool → [B,512]. The backbone IS an nn.Sequential whose children
are named 0..7 (conv1, bn1, relu, maxpool, layer1..layer4), so its state
dict carries the reference names (`backbone.0.weight`,
`backbone.4.0.conv1.weight`, …). In eval mode torch's BatchNorm2d with
running stats is the JAX package's TorchBatchNorm.
"""
from __future__ import annotations

import torch
from torch import nn


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, **fk)
        self.bn1 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1, **fk)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, **fk)
        self.bn2 = nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1, **fk)
        self.downsample = None
        if inplanes != planes or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, bias=False, **fk),
                nn.BatchNorm2d(planes, eps=1e-5, momentum=0.1, **fk),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + r)


#: (filters, stride) of layer1..layer4
STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


class ResNet18Backbone(nn.Sequential):
    """conv1..layer4 of ResNet-18. Input [B,3,H,W].

    include_pool=False → [B, 512, H/32, W/32];
    include_pool=True  → [B, 512] (global average pool).
    """

    def __init__(self, include_pool: bool = False, *, device=None, dtype=None):
        fk = dict(device=device, dtype=dtype)
        layers = []
        inplanes = 64
        for filters, stride in STAGES:
            layers.append(nn.Sequential(
                BasicBlock(inplanes, filters, stride, **fk),
                BasicBlock(filters, filters, 1, **fk),
            ))
            inplanes = filters
        super().__init__(
            nn.Conv2d(3, 64, 7, 2, 3, bias=False, **fk),
            nn.BatchNorm2d(64, eps=1e-5, momentum=0.1, **fk),
            nn.ReLU(),
            nn.MaxPool2d(3, 2, 1),
            *layers,
        )
        self.include_pool = include_pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = super().forward(x)
        if self.include_pool:
            x = x.mean(dim=(2, 3))
        return x
