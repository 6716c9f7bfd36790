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

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence

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
from automoe_tpu_torch.models.extractors import ExpertExtractors, pool_uv_mean
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


def full_context_data(batch: Dict[str, Any], B: int, dtype, device) -> Dict[str, Any]:
    """The `context_data` dict of the 'full' extractor, as the JAX model
    builds it: speed and each control the last step as [B,1] when present
    (each on its own), zeros otherwise; `hour`, `minute` and the `weather`
    and `road` dicts as the batch gives them."""
    zeros = torch.zeros((B, 1), dtype=dtype, device=device)
    data = {k: _last_step(batch[k]).to(dtype) if k in batch else zeros for k in _SIMPLE_KEYS}
    data.update(hour=batch.get("hour", zeros).to(dtype),
                minute=batch.get("minute", zeros).to(dtype))
    for k in ("weather", "road"):
        data[k] = {n: v.to(dtype) for n, v in (batch.get(k) or {}).items()}
    return data


def lidar_or_zeros(batch: Dict[str, torch.Tensor], B: int, dtype, device) -> torch.Tensor:
    """The batch's [B,P,3] points, or 1000 zero points per frame when it
    has none (camera-only serving), as the JAX model feeds a LiDAR
    nuScenes expert."""
    lidar = batch.get("lidar")
    if lidar is None:
        return torch.zeros((B, 1000, 3), dtype=dtype, device=device)
    return lidar


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

    def context_features(self, batch: Dict[str, Any], B: int, dtype, device) -> torch.Tensor:
        """The batch's context through the context extractor ('simple':
        `simple_context`; 'full': `full_context_data`)."""
        if self.config.context.type == "simple":
            return self.context_extractor(*simple_context(batch, B, dtype, device))
        return self.context_extractor(full_context_data(batch, B, dtype, device))

    def head_outputs(self, image: torch.Tensor, expert_features: List[torch.Tensor],
                     context_features: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None,
                     noise: bool = True) -> Dict[str, Any]:
        """Gating + policy over the extractor features; `image` is NCHW.
        generator and noise go to the gating network's routing."""
        gating_output = self.gating_network(expert_features, context_features,
                                            generator=generator, noise=noise)
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

    def forward(self, batch: Dict[str, torch.Tensor], *, experts_eval: bool = False,
                cached_pooled: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """experts_eval: the (frozen) experts run in eval mode — BatchNorm
        on running statistics, which stay put, and the nuScenes expert's
        dropout off — while the rest of the model keeps its own mode (the
        standard frozen-BN variant of the reference's train-mode experts).
        cached_pooled: per-expert pooled extractor inputs
        (`automoe_pooled_features`, train/feature_cache.py); the expert
        trunks are skipped and the extractor heads consume these, so
        `expert_outputs` is empty. Equivalent to experts_eval.
        generator: the source of the routing noise, which top-k routing
        with noise_scale > 0 needs (`GatingNetwork._route`)."""
        image = batch["image"]
        if image.ndim != 4 or image.shape[-1] != 3:
            raise ValueError(f"expected NHWC image [B,H,W,3], got {tuple(image.shape)}")
        image = image.permute(0, 3, 1, 2)  # NHWC → NCHW, once
        B = image.shape[0]
        context_features = self.context_features(batch, B, image.dtype, image.device)
        if cached_pooled is not None:
            expert_outputs = []
            features = [ext(None, pooled=p) for ext, p in
                        zip(self.expert_extractors.extractors, cached_pooled)]
        else:
            with eval_mode(self.experts) if experts_eval else contextlib.nullcontext():
                expert_outputs = [
                    expert(image, lidar_or_zeros(batch, B, image.dtype, image.device))
                    if ecfg.type == "nuscenes" and ecfg.use_lidar else expert(image)
                    for ecfg, expert in zip(self.config.experts, self.experts)
                ]
            features = self.extractor_features(expert_outputs, image.shape[2:])
        out = self.head_outputs(image, features, context_features, generator=generator)
        out["expert_outputs"] = expert_outputs
        return out


@contextlib.contextmanager
def eval_mode(module: nn.Module) -> Iterator[None]:
    """`module` in eval mode for the block, its mode restored after it."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


@torch.no_grad()
def automoe_pooled_features(model: AutoMoE, batch: Dict[str, torch.Tensor]
                            ) -> List[torch.Tensor]:
    """Eval-mode expert forward plus the extractors' parameter-free
    pooling, without their MLPs: the per-sample quantity the frozen-expert
    feature cache stores (train/feature_cache.py). Per expert type:
      detection → mean over h,w of concat(class_logits, bbox_deltas)  [B, C+4]
      seg / drv → exact mean-of-resize pool of the LOW-RES logits     [B, C]
                  (u^T x v equals the mean of the upsampled map)
      nuscenes  → flatten concat(class_logits, bbox_preds)            [B, Q*(C+bb)]
    Returned as float32."""
    image = batch["image"].permute(0, 3, 1, 2)
    B, hw = image.shape[0], tuple(image.shape[2:])
    pooled = []
    with eval_mode(model.experts):
        for ecfg, expert in zip(model.config.experts, model.experts):
            if ecfg.type == "nuscenes":
                out = (expert(image, lidar_or_zeros(batch, B, image.dtype, image.device))
                       if ecfg.use_lidar else expert(image))
                p = torch.cat([out["class_logits"], out["bbox_preds"]], -1).reshape(B, -1)
            elif ecfg.type == "detection":
                out = expert(image)
                p = torch.cat([out["class_logits"], out["bbox_deltas"]], 1).mean(dim=(2, 3))
            else:  # segmentation / drivable: pool the low-res logits, no upsample
                low = expert.heads(expert.backbone(image))
                p = pool_uv_mean(low, model._pool_uv(low, hw))
            pooled.append(p.float())
    return pooled


@torch.no_grad()
def automoe_context_weights(model: AutoMoE, batch: Dict[str, Any]) -> torch.Tensor:
    """Expert weights from the context alone, without running the experts
    (the reference's AutoMoE.get_expert_weights: zero PROCESSED features
    past the expert processors), for 'simple' and 'full' context, in eval
    mode with noise-free routing. Analysis only.

    The controls are read as `AutoMoE.forward` reads them. (The JAX
    package's automoe_context_weights reads each control of a 'simple'
    batch on its own, unlike its model's forward, which takes them only
    when all four are present.)"""
    speed = batch["speed"]
    B = speed.shape[0]
    dtype = next(model.context_extractor.parameters()).dtype
    with eval_mode(model):
        ctx = model.context_features(batch, B, dtype, speed.device)
        return model.gating_network.context_only_weights(ctx)  # no generator: noise-free


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded re-init with torch's default distributions (Linear/Conv:
    U(±1/sqrt(fan_in)); Embedding: N(0,1); norms: ones/zeros); a module
    with its own `seeded_init(generator)` (the deep policy's stacked
    trunk) draws its parameters there. Values are drawn on the CPU from
    `generator`, so a seed gives the same weights on every device."""
    for m in module.modules():
        if hasattr(m, "seeded_init"):
            m.seeded_init(generator)
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
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
