"""MoE gating network (port of automoe_tpu/models/gating.py).

A context encoder MLP, per-expert output processors, a gate MLP over
[context ∥ all processed outputs], optional noisy top-k routing, softmax
(or normalized sigmoid) weights, and a weighted sum + output projection.
Module names follow the reference (`context_encoder.context_encoder.*`,
`expert_processors.{i}.processor.*`, `gate_network.*`,
`output_projection`).

The routing noise is drawn from a `torch.Generator` the caller passes
(the JAX package's 'gating' RNG stream). Train mode is the module's own
(`nn.Module.train`), as for dropout.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

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


def _topk_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k logits per row, set the rest to -inf. Ties go to the
    lower index (a stable sort), as `jax.lax.top_k` breaks them."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    masked = torch.full_like(logits, float("-inf"))
    return masked.scatter(-1, idx, logits.gather(-1, idx))


def sample_noise(noise_type: str, noise_scale: float, shape, generator: torch.Generator
                 ) -> torch.Tensor:
    """float32 routing noise on `generator`'s device: Gumbel(0, scale)
    (uniforms clipped to [1e-6, 1 - 1e-6]), N(0, scale²), or zeros for any
    other type."""
    dev = generator.device
    kind = noise_type.lower()
    if kind == "gumbel":
        u = torch.rand(shape, generator=generator, device=dev).clamp(1e-6, 1 - 1e-6)
        return -torch.log(-torch.log(u)) * noise_scale
    if kind == "gaussian":
        return torch.randn(shape, generator=generator, device=dev) * noise_scale
    return torch.zeros(shape, device=dev)


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
        top_k: int = 0,
        noise_type: str = "gumbel",
        noise_scale: float = 1.0,
        apply_topk_at_eval: bool = False,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        dims = list(expert_output_dims or [processed_dim] * num_experts)
        self.num_experts = num_experts
        self.processed_dim = processed_dim
        self.temperature = temperature
        self.use_softmax = use_softmax
        self.top_k = top_k
        self.noise_type = noise_type
        self.noise_scale = noise_scale
        self.apply_topk_at_eval = apply_topk_at_eval
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

    def _route(self, gate_logits: torch.Tensor, train: bool,
               generator: Optional[torch.Generator], noise: bool,
               analysis: bool) -> torch.Tensor:
        """Expert weights from the gate logits: top-k (with train, or at
        eval with apply_topk_at_eval) over the logits plus routing noise.
        The noise needs `generator`, except with noise=False (serving's
        deterministic routing) and on the analysis path without one (which
        routes noise-free); elsewhere a missing generator raises, as a
        missing 'gating' RNG stream does in the JAX package."""
        if not (self.top_k > 0 and (train or self.apply_topk_at_eval)):
            return self._weights_from_logits(gate_logits)
        noisy = gate_logits
        if noise and self.noise_scale > 0.0:
            if generator is not None:
                noisy = gate_logits + sample_noise(
                    self.noise_type, self.noise_scale, gate_logits.shape, generator
                ).to(gate_logits.device)
            elif not analysis:
                raise ValueError(
                    "top-k routing with noise_scale > 0 draws its noise from a "
                    "torch.Generator: pass generator="
                )
        return self._weights_from_logits(_topk_mask(noisy, self.top_k))

    def forward(self, expert_outputs: List[torch.Tensor], context: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                noise: bool = True) -> Dict[str, Any]:
        """generator: the routing noise's source (see `_route`); noise=False
        routes without noise, as the JAX package's force_deterministic."""
        assert len(expert_outputs) == self.num_experts
        ctx_feat = self.context_encoder(context)
        processed = [p(o) for p, o in zip(self.expert_processors, expert_outputs)]
        gate_logits = self.gate_network(torch.cat([ctx_feat, *processed], dim=-1))
        gate_weights = self._route(gate_logits, self.training, generator, noise,
                                   analysis=False)
        stacked = torch.stack(processed, dim=1)  # [B, E, processed_dim]
        combined = torch.einsum("be,bed->bd", gate_weights.to(stacked.dtype), stacked)
        return {
            "combined_output": self.output_projection(combined),
            "expert_weights": gate_weights,
            "processed_expert_outputs": processed,
            "gate_logits": gate_logits,
        }

    def _context_only(self, context: torch.Tensor, generator):
        """Analysis path: zero PROCESSED features go straight into the gate
        input. The expert processors are bypassed, not fed zeros (their
        bias and LayerNorm would make processed zeros nonzero). Eval-mode
        routing: top-k only with apply_topk_at_eval."""
        ctx_feat = self.context_encoder(context)
        zeros = ctx_feat.new_zeros((context.shape[0], self.processed_dim * self.num_experts))
        gate_logits = self.gate_network(torch.cat([ctx_feat, zeros], dim=-1))
        return self._route(gate_logits, False, generator, True, analysis=True), gate_logits

    def context_only_weights(self, context: torch.Tensor, *,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Expert weights from the context alone (`_context_only`). Without
        a generator the routing is noise-free; with one it is noisy, as the
        reference's get_expert_weights."""
        return self._context_only(context, generator)[0]

    def context_only_logits(self, context: torch.Tensor) -> torch.Tensor:
        """Raw gate logits from the context alone."""
        return self._context_only(context, None)[1]


def gating_network_from_config(cfg, *, force_deterministic: bool = False,
                               device=None, dtype=None) -> GatingNetwork:
    """Build the composite's GatingNetwork from an AutoMoEConfig, with the
    reference quirk: the composite drops top_k and routing noise unless
    gating.honor_topk_in_composite opts in. `force_deterministic` zeroes
    the routing noise (serving and analysis)."""
    g = cfg.gating
    honor = g.honor_topk_in_composite
    return GatingNetwork(
        num_experts=len(cfg.experts),
        context_dim=cfg.context.context_dim,
        expert_output_dims=[e.output_dim for e in cfg.experts],
        processed_dim=g.processed_dim,
        hidden_dim=g.hidden_dim,
        temperature=g.temperature,
        use_softmax=g.use_softmax,
        top_k=g.top_k if honor else 0,
        noise_type=g.noise_type,
        noise_scale=0.0 if force_deterministic else (g.noise_scale if honor else 0.0),
        apply_topk_at_eval=g.apply_topk_at_eval if honor else False,
        device=device,
        dtype=dtype,
    )


class MoEArchitecture(nn.Module):
    """Generic experts + gating + policy wrapper (the reference's unused
    alternative to AutoMoE, kept for API completeness): every expert
    consumes the same input dict, their outputs combine through the gating
    network, and a policy head maps the combined features."""

    def __init__(self, experts: Sequence[nn.Module], gating_network: GatingNetwork,
                 policy_head: nn.Module):
        super().__init__()
        self.experts = nn.ModuleList(experts)
        self.gating_network = gating_network
        self.policy_head = policy_head

    def forward(self, inputs: Dict[str, torch.Tensor], context: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        expert_outputs = [expert(inputs) for expert in self.experts]
        gating_output = self.gating_network(expert_outputs, context, generator=generator)
        return {
            "policy_output": self.policy_head(gating_output["combined_output"]),
            "expert_weights": gating_output["expert_weights"],
            "combined_features": gating_output["combined_output"],
            "expert_outputs": expert_outputs,
        }
