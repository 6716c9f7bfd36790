"""Workload definitions: model + loss closure per training pipeline (port
of automoe_tpu/train/workloads.py). Ported so far: the BDD / CARLA
detection expert (`bdd_expert_workload("detection")`), the standalone
trajectory policy (`policy_workload`, 4-conv backbone only) and the
gating network over the full AutoMoE (`gating_workload`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from automoe_tpu_torch.configs import AutoMoEConfig, load_model_config
from automoe_tpu_torch.losses.detection import detection_set_loss
from automoe_tpu_torch.losses.trajectory import gating_losses, policy_losses
from automoe_tpu_torch.models.automoe import AutoMoE, expert_param_mask, init_parameters
from automoe_tpu_torch.models.experts import BDDDetectionExpert
from automoe_tpu_torch.models.policy import TrajectoryPolicy

# loss_fn(model, batch, train) -> (loss, metrics): batch holds tensors on
# the model's device, images NHWC as the loaders give them
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], bool],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class Workload:
    name: str
    build_model: Callable[[], nn.Module]
    loss_fn: LossFn
    # model -> {parameter name: trainable}; None trains every parameter
    trainable_mask_fn: Optional[Callable[[nn.Module], Dict[str, bool]]] = None

    def trainable_mask(self, model: nn.Module) -> Optional[Dict[str, bool]]:
        return self.trainable_mask_fn(model) if self.trainable_mask_fn else None

    def init_model(self, seed: int, device) -> nn.Module:
        """The model with seeded weights (drawn on the CPU from one
        torch.Generator, so a seed gives the same weights on every
        device), moved to `device`. Parameters the trainable mask freezes
        get requires_grad=False, so no backward runs through them; the
        optimizer gives them no update (the JAX package's masked update)."""
        model = self.build_model()
        init_parameters(model, torch.Generator().manual_seed(seed))
        mask = self.trainable_mask(model) or {}
        for name, p in model.named_parameters():
            p.requires_grad_(mask.get(name, True))
        return model.to(device).train()


def default_matcher(device) -> str:
    """The CUDA auction kernel on the card, the vectorised auction
    elsewhere (as the JAX package picks its Pallas kernel on the TPU)."""
    return "auction_kernel" if torch.device(device).type == "cuda" else "auction"


def bdd_expert_workload(task: str, *, num_classes: Optional[int] = None,
                        bbox_loss_weight: float = 2.0, cost_class: float = 1.0,
                        cost_bbox: float = 5.0, cost_giou: float = 2.0,
                        matcher: Optional[str] = None) -> Workload:
    """BDD100K expert training and its CARLA fine-tune (the same workload
    over another data source). matcher None: `default_matcher` of the
    device the batch lies on. Validation adds the reference's per-batch
    avg_iou / recall_0.5 from the loss's own matching. Batches hold
    NHWC images; the image size and box cap are the data's."""
    if task != "detection":
        raise NotImplementedError(f"the {task} task is not ported yet")
    C = 10 if num_classes is None else num_classes

    def loss_fn(model, batch, train):
        image = batch["image"]
        out = model(image.permute(0, 3, 1, 2))
        res = detection_set_loss(
            out["class_logits"], out["bbox_deltas"], batch["bboxes"], batch["labels"],
            num_classes=C, bbox_loss_weight=bbox_loss_weight, cost_class=cost_class,
            cost_bbox=cost_bbox, cost_giou=cost_giou,
            matcher=matcher or default_matcher(image.device))
        metrics = {"class_loss": res["class_loss"], "bbox_loss": res["bbox_loss"]}
        if not train:
            from automoe_tpu_torch.evals.detection import matched_iou_recall

            B, _, hh, ww = out["class_logits"].shape
            pred_boxes = out["bbox_deltas"].permute(0, 2, 3, 1).reshape(B, hh * ww, 4)
            si, sr, has = matched_iou_recall(pred_boxes, batch["bboxes"], res["query_idx"],
                                             res["valid"])
            denom = torch.clamp(has.sum(), min=1)
            metrics["avg_iou"] = torch.where(has, si, torch.zeros_like(si)).sum() / denom
            metrics["recall_0.5"] = torch.where(has, sr, torch.zeros_like(sr)).sum() / denom
        return res["loss"], metrics

    return Workload(name=f"bdd_{task}", build_model=lambda: BDDDetectionExpert(num_classes=C),
                    loss_fn=loss_fn)


# ---------------------------------------------------------------------------
# CARLA trajectory policy
# ---------------------------------------------------------------------------

def policy_workload(*, horizon: int = 8, context_dim: int = 0,
                    trunk_depth: int = 0) -> Workload:
    """Standalone TrajectoryPolicy training (the reference's
    train_carla_policy.py): loss = ADE + 2 FDE + 0.2 speed L1 + 0.1
    smoothness. With context_dim > 0 the batch's `context` vector feeds
    the heads. The deep residual trunk (trunk_depth > 0) is not ported."""
    if trunk_depth > 0:
        raise NotImplementedError("the deep policy trunk (--trunk-depth) is not ported yet")

    def loss_fn(model, batch, train):
        ctx = batch.get("context") if context_dim > 0 else None
        out = model(batch["image"].permute(0, 3, 1, 2), ctx)
        res = policy_losses(out, batch["waypoints"], batch["speed"])
        return res["loss"], {k: v for k, v in res.items() if k != "loss"}

    return Workload(
        name="carla_policy",
        build_model=lambda: TrajectoryPolicy(horizon=horizon, context_dim=context_dim),
        loss_fn=loss_fn)


# ---------------------------------------------------------------------------
# Gating network (full AutoMoE, frozen experts)
# ---------------------------------------------------------------------------

def pooled_feature_dim(ecfg) -> int:
    """Width of an expert's parameter-free pooled extractor input (the
    extractors' pooling before their MLPs)."""
    if ecfg.type == "detection":
        return ecfg.num_classes + 4
    if ecfg.type in ("segmentation", "drivable"):
        return ecfg.num_classes
    return ecfg.num_queries * (ecfg.num_classes + ecfg.bbox_dim)


def gating_workload(model_config: Any, *, loss_config: Optional[Mapping] = None,
                    freeze_experts: bool = True) -> Workload:
    """Gating training over the full AutoMoE (the reference's
    train_gating_network.py): the experts are frozen (no gradient, no
    update) while the extractors, context encoder, gating network and
    policy head train. As in the JAX package's default, the frozen
    experts still run in train mode: their BatchNorm normalises with batch
    statistics and its running statistics move, and their dropout is live."""
    cfg: AutoMoEConfig = load_model_config(model_config)
    lcfg = dict(loss_config or {})

    def loss_fn(model, batch, train):
        res = gating_losses(model(batch), batch["waypoints"], batch["speed"], lcfg)
        return res["total_loss"], {k: v for k, v in res.items() if k != "total_loss"}

    return Workload(
        name="gating", build_model=lambda: AutoMoE(cfg), loss_fn=loss_fn,
        trainable_mask_fn=(lambda m: expert_param_mask(m.named_parameters()))
        if freeze_experts else None)
