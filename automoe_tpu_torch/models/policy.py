"""Trajectory policy head (port of automoe_tpu/models/policy.py).

A small 4-stage strided CNN (EasyBackbone, `net.{0,1,3,4,6,7,9,10}`) →
global pool → FC, then two 3-layer MLP heads over [image_feat ∥ context]
producing ego-frame waypoints [B,H,2] and a speed profile [B,H].
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


class EasyBackbone(nn.Module):
    def __init__(self, out_dim: int = 512, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        layers, cin = [], 3
        for ch, k, p in ((32, 5, 2), (64, 3, 1), (128, 3, 1), (256, 3, 1)):
            layers += [
                nn.Conv2d(cin, ch, k, 2, p, **fk),
                nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1, **fk),
                nn.ReLU(),
            ]
            cin = ch
        self.net = nn.Sequential(*layers)
        self.fc = nn.Linear(256, out_dim, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.net(x).mean(dim=(2, 3)))


class _Head(nn.Sequential):
    def __init__(self, in_features: int, out_features: int, hidden: int = 512, *,
                 device=None, dtype=None):
        fk = dict(device=device, dtype=dtype)
        super().__init__(
            nn.Linear(in_features, hidden, **fk), nn.ReLU(),
            nn.Linear(hidden, hidden, **fk), nn.ReLU(),
            nn.Linear(hidden, out_features, **fk),
        )


class TrajectoryPolicy(nn.Module):
    def __init__(self, horizon: int = 8, context_dim: int = 0,
                 backbone_dim: int = 512, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.horizon = horizon
        self.backbone = EasyBackbone(backbone_dim, **fk)
        self.head_wp = _Head(backbone_dim + context_dim, horizon * 2, **fk)
        self.head_spd = _Head(backbone_dim + context_dim, horizon, **fk)

    def forward(self, image: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        feat = self.backbone(image)
        x = feat if context is None else torch.cat([feat, context], dim=-1)
        return {
            "waypoints": self.head_wp(x).reshape(-1, self.horizon, 2),
            "speed": self.head_spd(x).reshape(-1, self.horizon),
        }
