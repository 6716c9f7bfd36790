"""Expert-output → uniform [B, output_dim] feature extractors for gating
(port of automoe_tpu/models/extractors.py).

Dense maps are globally average-pooled then pushed through Linear(→512)-
ReLU-Dropout(0.1)-Linear(→out)-LayerNorm; nuScenes query outputs are
flattened to [B, Q*(C+bbox_dim)] first. `feature_extractor` is the
reference's nn.Sequential: for dense maps its children 0/1 are the
(parameter-free) pool and flatten, so the Linear/LayerNorm layers sit at
2/5/6; for nuScenes at 0/3/4.

`pool_uv` (u [h], v [w]) replaces the plain pool by the exact
mean-of-resize pool over LOW-RES logits (ops/resize.py
mean_of_resize_weights) — the serving fast path.

Every extractor splits as (parameter-free pool/flatten) → (trainable MLP
head). `pooled=` feeds the head directly and skips the pool: the hook the
frozen-expert feature cache uses to train gating without running the
expert trunks (train/feature_cache.py). The parameters are the same
either way.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn


def _mlp(in_dim: int, output_dim: int, fk) -> list:
    return [
        nn.Linear(in_dim, 512, **fk), nn.ReLU(), nn.Dropout(0.1),
        nn.Linear(512, output_dim, **fk), nn.LayerNorm(output_dim, eps=1e-5, **fk),
    ]


def pool_uv_mean(x: torch.Tensor, uv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """[B,C,h,w] → [B,C]: u^T x v per channel (== GAP of the upsampled map)."""
    u, v = uv
    return torch.einsum("h,bchw,w->bc", u.to(x.dtype), x, v.to(x.dtype))


class _DenseMapExtractor(nn.Module):
    """GAP (or mean-of-resize pool) over a [B,C,h,w] map → MLP."""

    def __init__(self, in_channels: int, output_dim: int = 256, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.feature_extractor = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), *_mlp(in_channels, output_dim, fk)
        )

    def _dense_map(self, expert_output) -> torch.Tensor:
        return expert_output

    def forward(self, expert_output, *, pool_uv=None,
                pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pooled is not None:  # [B,C]: the cached pool
            return self.feature_extractor[2:](pooled)
        x = self._dense_map(expert_output)
        if pool_uv is not None:
            return self.feature_extractor[2:](pool_uv_mean(x, pool_uv))
        return self.feature_extractor(x)


class DetectionExpertExtractor(_DenseMapExtractor):
    """GAP(concat(class_logits, bbox_deltas)) → MLP → [B, output_dim]."""

    def __init__(self, output_dim: int = 256, num_classes: int = 10, *,
                 device=None, dtype=None):
        super().__init__(num_classes + 4, output_dim, device=device, dtype=dtype)

    def _dense_map(self, expert_output) -> torch.Tensor:
        return torch.cat(
            [expert_output["class_logits"], expert_output["bbox_deltas"]], dim=1
        )


class SegmentationExpertExtractor(_DenseMapExtractor):
    def __init__(self, output_dim: int = 256, num_classes: int = 19, *,
                 device=None, dtype=None):
        super().__init__(num_classes, output_dim, device=device, dtype=dtype)


class DrivableExpertExtractor(_DenseMapExtractor):
    def __init__(self, output_dim: int = 256, num_classes: int = 3, *,
                 device=None, dtype=None):
        super().__init__(num_classes, output_dim, device=device, dtype=dtype)


class NuScenesExpertExtractor(nn.Module):
    def __init__(self, output_dim: int = 256, num_queries: int = 100,
                 num_classes: int = 10, bbox_dim: int = 7, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.feature_extractor = nn.Sequential(
            *_mlp(num_queries * (num_classes + bbox_dim), output_dim, fk)
        )

    def forward(self, expert_output, *, pool_uv=None,
                pooled: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pooled is None:
            combined = torch.cat(
                [expert_output["class_logits"], expert_output["bbox_preds"]], dim=-1
            )  # [B,Q,C+bbox]
            pooled = combined.reshape(combined.shape[0], -1)
        return self.feature_extractor(pooled)


def make_extractor(expert_config, *, device=None, dtype=None) -> nn.Module:
    """Factory mirroring reference create_expert_extractors."""
    fk = dict(device=device, dtype=dtype)
    t = expert_config.type
    if t == "detection":
        return DetectionExpertExtractor(
            expert_config.output_dim, expert_config.num_classes, **fk
        )
    if t == "segmentation":
        return SegmentationExpertExtractor(
            expert_config.output_dim, expert_config.num_classes, **fk
        )
    if t == "drivable":
        return DrivableExpertExtractor(
            expert_config.output_dim, expert_config.num_classes, **fk
        )
    if t == "nuscenes":
        return NuScenesExpertExtractor(
            expert_config.output_dim,
            expert_config.num_queries,
            expert_config.num_classes,
            expert_config.bbox_dim,
            **fk,
        )
    raise ValueError(f"Unknown expert type: {t}")


class ExpertExtractors(nn.Module):
    """The reference's `expert_extractors` container: `extractors.{i}`."""

    def __init__(self, expert_configs, *, device=None, dtype=None):
        super().__init__()
        self.extractors = nn.ModuleList(
            make_extractor(e, device=device, dtype=dtype) for e in expert_configs
        )
