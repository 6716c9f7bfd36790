"""Driving-context encoder (port of automoe_tpu/models/context.py).

Only the 'simple' extractor is ported; the shipped config uses it. The
'full' extractor (weather, time, road) is not ported yet.
"""
from __future__ import annotations

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


def make_context_extractor(context_config, *, device=None, dtype=None) -> nn.Module:
    if context_config.type == "simple":
        return SimpleContextExtractor(
            context_config.context_dim, device=device, dtype=dtype
        )
    if context_config.type == "full":
        raise NotImplementedError("the 'full' context extractor is not ported yet")
    raise ValueError(f"Unknown context extractor type: {context_config.type}")
