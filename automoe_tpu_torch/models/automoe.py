"""AutoMoE composite model (port of automoe_tpu/models/automoe.py):
experts + extractors + context + gating + policy.

Submodule names follow the reference state dict that the JAX package's
`ckpt/torch_export.py` emits (`experts.{i}.*`,
`expert_extractors.extractors.{i}.*`, `context_extractor.*`,
`gating_network.*`, `policy_head.*`), so `load_state_dict(strict=True)`
accepts that dict unchanged. Images enter as NHWC [B,H,W,3], the layout
of the JAX package's batches, and are permuted to NCHW once, at entry.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from automoe_tpu_torch.configs import AutoMoEConfig, load_model_config
from automoe_tpu_torch.models.context import make_context_extractor
from automoe_tpu_torch.models.experts import (
    BDDDetectionExpert,
    BDDDrivableExpert,
    BDDSegmentationExpert,
    NuScenesExpert,
)
from automoe_tpu_torch.models.extractors import ExpertExtractors
from automoe_tpu_torch.models.gating import gating_network_from_config
from automoe_tpu_torch.models.policy import TrajectoryPolicy
from automoe_tpu_torch.ops.resize import mean_of_resize_weights
from automoe_tpu_torch.utils import resolve_device


def _make_expert(cfg, *, upsample: bool = True, device=None, dtype=None) -> nn.Module:
    fk = dict(device=device, dtype=dtype)
    if cfg.type == "detection":
        return BDDDetectionExpert(cfg.num_classes, **fk)
    if cfg.type == "segmentation":
        return BDDSegmentationExpert(cfg.num_classes, upsample=upsample, **fk)
    if cfg.type == "drivable":
        return BDDDrivableExpert(cfg.num_classes, upsample=upsample, **fk)
    if cfg.type == "nuscenes":
        return NuScenesExpert(
            num_queries=cfg.num_queries,
            fusion=cfg.fusion,
            use_lidar=cfg.use_lidar,
            use_tnet=cfg.use_tnet,
            bbox_dim=cfg.bbox_dim,
            num_classes=cfg.num_classes,
            **fk,
        )
    raise ValueError(f"Unknown expert type: {cfg.type}")


def _last_step(x: torch.Tensor) -> torch.Tensor:
    """[B] → [B,1]; [B,T>1] → last step [B,1]."""
    if x.ndim == 1:
        return x[:, None]
    if x.ndim == 2:
        return x[:, -1:]
    return x.reshape(x.shape[0], -1)[:, -1:]


_SIMPLE_KEYS = ("speed", "steering", "throttle", "brake")


def simple_context(batch: Dict[str, torch.Tensor], B: int, dtype, device):
    """(speed, steering, throttle, brake), each the last step as [B,1], as
    the JAX model reads them: speed when present, the three controls only
    when all four keys are present (the CARLA sequence batches), zeros
    otherwise (controls are unavailable at inference)."""
    zeros = torch.zeros((B, 1), dtype=dtype, device=device)
    has_all = all(k in batch for k in _SIMPLE_KEYS)
    return [
        _last_step(batch[k]).to(dtype) if k in batch and (k == "speed" or has_all) else zeros
        for k in _SIMPLE_KEYS
    ]


class AutoMoE(nn.Module):
    """fast_gating_pool: seg/drivable experts skip the full-res bilinear
    upsample and their gating extractors pool the low-res logits with
    exact mean-of-resize weights. expert_outputs then contain the LOW-RES
    maps."""

    def __init__(self, config: AutoMoEConfig, *, fast_gating_pool: bool = False,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.config = config
        self.fast_gating_pool = fast_gating_pool
        self.experts = nn.ModuleList(
            _make_expert(e, upsample=not fast_gating_pool, **fk)
            for e in config.experts
        )
        self.expert_extractors = ExpertExtractors(config.experts, **fk)
        self.context_extractor = make_context_extractor(config.context, **fk)
        self.gating_network = gating_network_from_config(config, **fk)
        self.policy_head = TrajectoryPolicy(
            horizon=config.policy.num_waypoints,
            context_dim=config.gating.processed_dim,
            backbone_dim=config.policy.backbone_dim,
            **fk,
        )
        self._uv_cache: Dict = {}

    def _pool_uv(self, low: torch.Tensor, image_hw):
        """Device copies of mean_of_resize_weights for a low-res map,
        cached per shape so a step uploads nothing."""
        key = (*low.shape[2:], *image_hw, low.device, low.dtype)
        if key not in self._uv_cache:
            u, v = mean_of_resize_weights(*low.shape[2:], *image_hw, False)
            self._uv_cache[key] = (torch.as_tensor(u, device=low.device).to(low.dtype),
                                   torch.as_tensor(v, device=low.device).to(low.dtype))
        return self._uv_cache[key]

    def extractor_features(self, expert_outputs: List[Any], image_hw) -> List[torch.Tensor]:
        """Expert outputs → gating inputs. Under fast_gating_pool the
        low-res dims come from the expert's ACTUAL output: the trunk's
        stride-32 reduction rounds up, so image_dim // 32 is wrong for
        non-multiple-of-32 inputs."""
        feats = []
        for ecfg, out, ext in zip(self.config.experts, expert_outputs,
                                  self.expert_extractors.extractors):
            uv = None
            if self.fast_gating_pool and ecfg.type in ("segmentation", "drivable"):
                uv = self._pool_uv(out, tuple(image_hw))
            feats.append(ext(out, pool_uv=uv))
        return feats

    def head_outputs(self, image: torch.Tensor, expert_features: List[torch.Tensor],
                     context_features: torch.Tensor) -> Dict[str, Any]:
        """Gating + policy over the extractor features; `image` is NCHW."""
        gating_output = self.gating_network(expert_features, context_features)
        policy_output = self.policy_head(image, gating_output["combined_output"])
        speed_seq = policy_output["speed"]
        return {
            "waypoints": policy_output["waypoints"],  # [B, horizon, 2]
            "speed": speed_seq[:, -1:],  # [B, 1] last-step speed
            "speed_seq": speed_seq,
            "expert_weights": gating_output["expert_weights"],  # [B, E]
            "context_features": context_features,  # [B, context_dim]
            "combined_features": gating_output["combined_output"],
            "gate_logits": gating_output["gate_logits"],  # [B, E]
        }

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        image = batch["image"]
        if image.ndim != 4 or image.shape[-1] != 3:
            raise ValueError(f"expected NHWC image [B,H,W,3], got {tuple(image.shape)}")
        image = image.permute(0, 3, 1, 2)  # NHWC → NCHW, once
        B = image.shape[0]
        context_features = self.context_extractor(
            *simple_context(batch, B, image.dtype, image.device)
        )
        expert_outputs = [expert(image) for expert in self.experts]
        features = self.extractor_features(expert_outputs, image.shape[2:])
        out = self.head_outputs(image, features, context_features)
        out["expert_outputs"] = expert_outputs
        return out


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded re-init with torch's default distributions (Linear/Conv:
    U(±1/sqrt(fan_in)); Embedding: N(0,1); norms: ones/zeros). Values are
    drawn on the CPU from `generator`, so a seed gives the same weights on
    every device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()


def expert_param_mask(named_params) -> Dict[str, bool]:
    """{parameter name: trainable}, the expert parameters (`experts.*`)
    frozen: the gating trainer's freeze, as the JAX package's
    `expert_param_mask` marks its `expert_*` subtrees."""
    return {n: not n.startswith("experts.") for n, _ in named_params}


def create_automoe_model(config, *, fast_gating_pool: bool = False, device=None,
                         dtype=torch.float32, seed: int = 0) -> AutoMoE:
    """Build AutoMoE from a config dict / JSON path / AutoMoEConfig with
    seeded random weights, in eval mode, on `device` (default cuda), for
    inference. The training counterpart is
    `train.workloads.gating_workload(config).init_model(seed, device)`: the
    same module in train mode, with its experts frozen."""
    dev = resolve_device(device)
    model = AutoMoE(load_model_config(config), fast_gating_pool=fast_gating_pool,
                    device=dev, dtype=dtype)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
