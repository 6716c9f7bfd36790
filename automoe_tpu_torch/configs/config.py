"""Typed config tree for the PyTorch port of AutoMoE (a copy of the JAX
package's configs/config.py: plain dataclasses, no framework imports).

One dataclass hierarchy replaces the reference's three-layer ad-hoc config
system (argparse + raw JSON + env vars; see SURVEY.md §5). The JSON schema
is key-compatible with the reference's models/configs/automoe/
model_config.json so reference configs load unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class ExpertConfig:
    type: str  # detection | segmentation | drivable | nuscenes
    num_classes: int = 10
    output_dim: int = 256
    pretrained_backbone: bool = True
    # nuScenes-only:
    num_queries: int = 100
    fusion: str = "concat"  # 'concat' | 'sum'
    use_lidar: bool = False
    use_tnet: bool = False
    bbox_dim: int = 7


@dataclass(frozen=True)
class GatingConfig:
    processed_dim: int = 256
    hidden_dim: int = 128
    temperature: float = 1.0
    use_softmax: bool = True
    top_k: int = 0
    noise_type: str = "gumbel"  # 'gumbel' | 'gaussian' | 'none'
    noise_scale: float = 1.0
    apply_topk_at_eval: bool = False
    # Reference quirk: AutoMoE._create_gating_network drops top_k/noise from
    # the gating config (automoe.py:78-91), so the shipped composite always
    # routes densely even though model_config.json says top_k=2. Default
    # False replicates that; set True to actually honor top-k in the
    # composite model.
    honor_topk_in_composite: bool = False


@dataclass(frozen=True)
class ContextConfig:
    type: str = "simple"  # 'simple' | 'full'
    context_dim: int = 64
    include_weather: bool = True
    include_time: bool = True
    include_road: bool = True


@dataclass(frozen=True)
class PolicyConfig:
    hidden_dim: int = 256
    num_waypoints: int = 10
    waypoint_dim: int = 2
    backbone_dim: int = 512


@dataclass(frozen=True)
class AutoMoEConfig:
    experts: List[ExpertConfig] = field(default_factory=list)
    gating: GatingConfig = field(default_factory=GatingConfig)
    context: ContextConfig = field(default_factory=ContextConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def load_model_config(source: Any) -> AutoMoEConfig:
    """Build an AutoMoEConfig from a path, JSON string, or dict.

    Accepts the reference's model_config.json schema verbatim
    (models/configs/automoe/model_config.json).
    """
    if isinstance(source, AutoMoEConfig):
        return source
    if isinstance(source, str) and source.lstrip().startswith("{"):
        data = json.loads(source)
    elif isinstance(source, (str, Path)):
        data = json.loads(Path(source).read_text())
    else:
        data = dict(source)
    return AutoMoEConfig(
        experts=[ExpertConfig(**_filter_kwargs(ExpertConfig, e)) for e in data.get("experts", [])],
        gating=GatingConfig(**_filter_kwargs(GatingConfig, data.get("gating", {}))),
        context=ContextConfig(**_filter_kwargs(ContextConfig, data.get("context", {}))),
        policy=PolicyConfig(**_filter_kwargs(PolicyConfig, data.get("policy", {}))),
    )


def default_model_config() -> AutoMoEConfig:
    """The shipped AutoMoE topology (mirrors the reference's
    models/configs/automoe/model_config.json values)."""
    return load_model_config(
        {
            "experts": [
                {"type": "detection", "num_classes": 10, "output_dim": 256},
                {"type": "segmentation", "num_classes": 19, "output_dim": 256},
                {"type": "drivable", "num_classes": 3, "output_dim": 256},
                {
                    "type": "nuscenes",
                    "num_queries": 196,
                    "num_classes": 10,
                    "output_dim": 256,
                    "fusion": "sum",
                    "use_lidar": False,
                    "use_tnet": False,
                    "bbox_dim": 4,
                },
            ],
            "gating": {
                "processed_dim": 256,
                "hidden_dim": 128,
                "temperature": 1.0,
                "use_softmax": True,
                "top_k": 2,
                "noise_type": "gumbel",
                "noise_scale": 0.0,
                "apply_topk_at_eval": True,
            },
            "context": {"type": "simple", "context_dim": 64},
            "policy": {"hidden_dim": 256, "num_waypoints": 10, "waypoint_dim": 2},
        }
    )
