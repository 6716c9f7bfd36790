"""Driving-context encoders (port of automoe_tpu/models/context.py).

The reference's 'full' extractor declares 2 time input dims but produces
4 (sin/cos of hour AND minute); as in the JAX package, the input width
here is what is actually produced (4 time features).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


class SimpleContextExtractor(nn.Module):
    """[speed, steering, throttle, brake] → Linear(4→32)-ReLU-Dropout(0.1)-
    Linear(32→context_dim)-LayerNorm, as `encoder.{0,3,4}`."""

    def __init__(self, context_dim: int = 64, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.encoder = nn.Sequential(
            nn.Linear(4, 32, **fk), nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(32, context_dim, **fk),
            nn.LayerNorm(context_dim, eps=1e-5, **fk),
        )

    def forward(self, speed, steering, throttle, brake) -> torch.Tensor:
        return self.encoder(torch.cat([speed, steering, throttle, brake], dim=-1))


class FullContextExtractor(nn.Module):
    """Vehicle state (4) + weather (4) + cyclical time (4) + road (3) →
    Linear-ReLU-Dropout(0.1)-Linear-LayerNorm, as `context_encoder.{0,3,4}`.

    `context_data` holds [B,1] tensors: `speed` (required), `steering`,
    `throttle`, `brake`, `hour`, `minute`, and the dicts `weather` (`rain`,
    `fog`, `wetness`, `sun_angle`) and `road` (`road_type`, `lane_count`,
    `curvature`). A missing entry is 0, except `lane_count`, which is 1."""

    def __init__(self, context_dim: int = 64, include_weather: bool = True,
                 include_time: bool = True, include_road: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.include_weather = include_weather
        self.include_time = include_time
        self.include_road = include_road
        width = 4 + 4 * include_weather + 4 * include_time + 3 * include_road
        self.context_encoder = nn.Sequential(
            nn.Linear(width, context_dim, **fk), nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(context_dim, context_dim, **fk),
            nn.LayerNorm(context_dim, eps=1e-5, **fk),
        )

    def forward(self, context_data: Dict) -> torch.Tensor:
        speed = context_data["speed"]
        zeros = torch.zeros_like(speed)
        ones = torch.ones_like(speed)
        feats = [speed] + [context_data.get(k, zeros) for k in ("steering", "throttle", "brake")]
        if self.include_weather:
            w = context_data.get("weather") or {}
            feats += [w.get(k, zeros) for k in ("rain", "fog", "wetness", "sun_angle")]
        if self.include_time:
            hour_rad = 2.0 * math.pi * context_data.get("hour", zeros) / 24.0
            minute_rad = 2.0 * math.pi * context_data.get("minute", zeros) / 60.0
            feats += [torch.sin(hour_rad), torch.cos(hour_rad),
                      torch.sin(minute_rad), torch.cos(minute_rad)]
        if self.include_road:
            r = context_data.get("road") or {}
            feats += [r.get("road_type", zeros), r.get("lane_count", ones),
                      r.get("curvature", zeros)]
        return self.context_encoder(torch.cat(feats, dim=-1))


def make_context_extractor(context_config, *, device=None, dtype=None) -> nn.Module:
    fk = dict(device=device, dtype=dtype)
    if context_config.type == "simple":
        return SimpleContextExtractor(context_config.context_dim, **fk)
    if context_config.type == "full":
        return FullContextExtractor(
            context_config.context_dim,
            context_config.include_weather,
            context_config.include_time,
            context_config.include_road,
            **fk,
        )
    raise ValueError(f"Unknown context extractor type: {context_config.type}")
