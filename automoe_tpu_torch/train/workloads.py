"""Workload definitions: model + loss closure per training pipeline (port
of automoe_tpu/train/workloads.py). Ported so far: the BDD / CARLA
detection expert (`bdd_expert_workload("detection")`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from automoe_tpu_torch.losses.detection import detection_set_loss
from automoe_tpu_torch.models.automoe import init_parameters
from automoe_tpu_torch.models.experts import BDDDetectionExpert

# loss_fn(model, batch, train) -> (loss, metrics): batch holds tensors on
# the model's device, images NHWC as the loaders give them
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], bool],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class Workload:
    name: str
    build_model: Callable[[], nn.Module]
    loss_fn: LossFn

    def init_model(self, seed: int, device) -> nn.Module:
        """The model with seeded weights (drawn on the CPU from one
        torch.Generator, so a seed gives the same weights on every
        device), moved to `device`."""
        model = self.build_model()
        init_parameters(model, torch.Generator().manual_seed(seed))
        return model.to(device)


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
