"""nuScenes expert set loss (port of automoe_tpu/losses/nuscenes.py).

After the set matching: CE with the unmatched class target -1 ignored
(mean over matched queries); SmoothL1 averaged over ALL queries, with
zero target boxes for the unmatched ones (the reference's quirk, kept:
unmatched box predictions are pulled toward zero); total = CE +
bbox_loss_weight (default 5.0) · SmoothL1.
"""
from __future__ import annotations

from typing import Dict

import torch

from automoe_tpu_torch.losses.detection import get_matcher, scatter_matched_targets
from automoe_tpu_torch.ops.masked import masked_cross_entropy, smooth_l1


def nuscenes_set_loss(class_logits: torch.Tensor, bbox_preds: torch.Tensor,
                      gt_boxes: torch.Tensor, gt_labels: torch.Tensor, *,
                      bbox_loss_weight: float = 5.0, cost_class: float = 1.0,
                      cost_bbox: float = 5.0, cost_giou: float = 2.0,
                      matcher: str = "hungarian") -> Dict[str, torch.Tensor]:
    """class_logits [B,Q,C]; bbox_preds [B,Q,D]; gt_boxes [B,M,D] (3D
    center format); gt_labels [B,M] padded with -1."""
    B, Q, C = class_logits.shape
    query_idx, valid = get_matcher(matcher)(
        class_logits, bbox_preds, gt_boxes, gt_labels,
        cost_class=cost_class, cost_bbox=cost_bbox, cost_giou=cost_giou)
    target_classes, target_boxes = scatter_matched_targets(
        query_idx, valid, gt_boxes, gt_labels, Q, num_classes=C)
    target_classes = torch.where(target_classes == C, -1, target_classes)
    class_loss = masked_cross_entropy(class_logits.reshape(B * Q, C),
                                      target_classes.reshape(B * Q), ignore_index=-1)
    bbox_loss = smooth_l1(bbox_preds, target_boxes).mean()  # over ALL queries
    return {
        "loss": class_loss + bbox_loss_weight * bbox_loss,
        "class_loss": class_loss,
        "bbox_loss": bbox_loss,
        "query_idx": query_idx,
        "valid": valid,
    }
