"""MoE gating network (port of automoe_tpu/models/gating.py).

A context encoder MLP, per-expert output processors, a gate MLP over
[context ∥ all processed outputs], softmax (or normalized sigmoid)
weights, and a weighted sum + output projection. Module names follow the
reference (`context_encoder.context_encoder.*`,
`expert_processors.{i}.processor.*`, `gate_network.*`,
`output_projection`).

Routing is dense: the composite drops top-k (see
`gating_network_from_config`); honoring top-k with routing noise is not
ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn


class ContextEncoder(nn.Module):
    """context [B,context_dim] → [B,hidden_dim]."""

    def __init__(self, context_dim: int, hidden_dim: int = 128, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.context_encoder = nn.Sequential(
            nn.Linear(context_dim, hidden_dim, **fk), nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(hidden_dim, hidden_dim, **fk), nn.ReLU(), nn.Dropout(0.1),
        )

    def forward(self, context: torch.Tensor) -> torch.Tensor:
        return self.context_encoder(context)


class ExpertOutputProcessor(nn.Module):
    """[B,expert_dim] → [B,processed_dim], LayerNormed."""

    def __init__(self, expert_dim: int, processed_dim: int = 256, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.processor = nn.Sequential(
            nn.Linear(expert_dim, processed_dim, **fk), nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(processed_dim, processed_dim, **fk),
            nn.LayerNorm(processed_dim, eps=1e-5, **fk),
        )

    def forward(self, expert_output: torch.Tensor) -> torch.Tensor:
        return self.processor(expert_output)


class GatingNetwork(nn.Module):
    def __init__(
        self,
        num_experts: int,
        context_dim: int = 64,
        expert_output_dims: Optional[Sequence[int]] = None,
        processed_dim: int = 256,
        hidden_dim: int = 128,
        temperature: float = 1.0,
        use_softmax: bool = True,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        dims = list(expert_output_dims or [processed_dim] * num_experts)
        self.num_experts = num_experts
        self.temperature = temperature
        self.use_softmax = use_softmax
        self.context_encoder = ContextEncoder(context_dim, hidden_dim, **fk)
        self.expert_processors = nn.ModuleList(
            ExpertOutputProcessor(d, processed_dim, **fk) for d in dims
        )
        self.gate_network = nn.Sequential(
            nn.Linear(hidden_dim + processed_dim * num_experts, hidden_dim, **fk),
            nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(hidden_dim, num_experts, **fk),
        )
        self.output_projection = nn.Linear(processed_dim, processed_dim, **fk)

    def _weights_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.use_softmax:
            return torch.softmax(logits / self.temperature, dim=-1)
        w = torch.sigmoid(logits)
        return w / (w.sum(dim=-1, keepdim=True) + 1e-8)

    def forward(self, expert_outputs: List[torch.Tensor],
                context: torch.Tensor) -> Dict[str, torch.Tensor]:
        assert len(expert_outputs) == self.num_experts
        ctx_feat = self.context_encoder(context)
        processed = [p(o) for p, o in zip(self.expert_processors, expert_outputs)]
        gate_in = torch.cat([ctx_feat, *processed], dim=-1)
        gate_logits = self.gate_network(gate_in)
        gate_weights = self._weights_from_logits(gate_logits)
        stacked = torch.stack(processed, dim=1)  # [B, E, processed_dim]
        combined = torch.einsum("be,bed->bd", gate_weights.to(stacked.dtype), stacked)
        return {
            "combined_output": self.output_projection(combined),
            "expert_weights": gate_weights,
            "processed_expert_outputs": processed,
            "gate_logits": gate_logits,
        }


def gating_network_from_config(cfg, *, device=None, dtype=None) -> GatingNetwork:
    """Build the composite's GatingNetwork from an AutoMoEConfig, with the
    reference quirk: the composite drops top_k and routing noise unless
    gating.honor_topk_in_composite opts in (and then top-k is honored,
    which this port does not support yet). Noise is therefore never on
    this path, so `force_deterministic` has nothing to zero here."""
    g = cfg.gating
    if g.honor_topk_in_composite and g.top_k > 0:
        raise NotImplementedError("top-k routing is not ported yet")
    return GatingNetwork(
        num_experts=len(cfg.experts),
        context_dim=cfg.context.context_dim,
        expert_output_dims=[e.output_dim for e in cfg.experts],
        processed_dim=g.processed_dim,
        hidden_dim=g.hidden_dim,
        temperature=g.temperature,
        use_softmax=g.use_softmax,
        device=device,
        dtype=dtype,
    )
