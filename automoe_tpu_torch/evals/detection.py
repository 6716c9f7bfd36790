"""BDD detection expert evaluation (port of automoe_tpu/evals/detection.py).

Metric definitions are the reference's (eval/evaluate_bdd100k_expert.py:
23-134), quirks included:
  * the val loss's SmoothL1 sums over matched boxes (reduction='sum'),
    where training takes the mean;
  * avg_iou: per sample the mean IoU of matched pred/GT pairs, averaged
    over the samples that have matches, then over batches;
  * recall@0.5: per sample the fraction of GT boxes some query covers at
    IoU >= 0.5, averaged over the samples with GT, then over batches.
The matches are the loss's exact ones ('hungarian': K2 alone on the card,
scipy on the CPU); the host loop only aggregates.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from automoe_tpu_torch.evals.common import Forward, as_forward
from automoe_tpu_torch.losses.detection import detection_set_loss
from automoe_tpu_torch.ops.boxes import box_convert, box_iou


def matched_iou_recall(pred_boxes: torch.Tensor, gt_boxes_xyxy: torch.Tensor,
                       query_idx: torch.Tensor, valid: torch.Tensor):
    """pred_boxes [B,Q,4] cxcywh, gt_boxes_xyxy [B,N,4], query_idx/valid
    [B,N] → (sample_iou [B], sample_recall [B], has_match [B]): the mean
    IoU of matched pairs, and the fraction of GT boxes some query covers
    at IoU >= 0.5."""
    B, N = query_idx.shape
    matched = torch.gather(pred_boxes, 1, query_idx.long()[..., None].expand(B, N, 4))
    pred_xyxy = box_convert(matched, "cxcywh", "xyxy")
    gt_xyxy = box_convert(box_convert(gt_boxes_xyxy, "xyxy", "cxcywh"), "cxcywh", "xyxy")
    pair_iou = torch.diagonal(box_iou(pred_xyxy, gt_xyxy), dim1=-2, dim2=-1)  # [B,N]
    n_valid = valid.sum(1)
    has_match = n_valid > 0
    zero = torch.zeros_like(pair_iou)
    sample_iou = torch.where(valid, pair_iou, zero).sum(1) / torch.clamp(n_valid, min=1)
    mat = box_iou(box_convert(pred_boxes, "cxcywh", "xyxy"), gt_boxes_xyxy)  # [B,Q,N]
    covered = mat.amax(1) >= 0.5
    sample_recall = (covered & valid).sum(1) / torch.clamp(n_valid, min=1)
    return sample_iou, sample_recall, has_match


@torch.no_grad()
def detection_eval_batch(class_logits: torch.Tensor, bbox_deltas: torch.Tensor,
                         gt_boxes_xyxy: torch.Tensor, gt_labels: torch.Tensor, *,
                         num_classes: int, bbox_loss_weight: float = 2.0
                         ) -> Dict[str, torch.Tensor]:
    """class_logits [B,C,h,w], bbox_deltas [B,4,h,w] (the expert's NCHW
    outputs), gt_boxes_xyxy [B,N,4], gt_labels [B,N] (-1 pads) →
    {loss, sample_iou, sample_recall, has_match}."""
    B, _, h, w = class_logits.shape
    res = detection_set_loss(class_logits.float(), bbox_deltas.float(), gt_boxes_xyxy,
                             gt_labels, num_classes=num_classes,
                             bbox_loss_weight=bbox_loss_weight,
                             bbox_reduction="sum")  # eval quirk
    pred_boxes = bbox_deltas.float().permute(0, 2, 3, 1).reshape(B, h * w, 4)
    sample_iou, sample_recall, has_match = matched_iou_recall(
        pred_boxes, gt_boxes_xyxy.float(), res["query_idx"], res["valid"])
    return {"loss": res["loss"], "sample_iou": sample_iou,
            "sample_recall": sample_recall, "has_match": has_match}


@torch.no_grad()
def evaluate_detection(model: Forward, batches: Iterable[Dict[str, np.ndarray]], *,
                       num_classes: int, bbox_loss_weight: float = 2.0,
                       device=None) -> Dict[str, float]:
    """`model` maps an NCHW image to {class_logits, bbox_deltas} (NCHW): the
    expert module in eval mode on its device, or a callable (the int8
    forward) with `device`. Batches are numpy (NHWC images, [B,N,4]
    bboxes, [B,N] labels)."""
    forward, dev = as_forward(model, device)
    total_loss, agg_iou, agg_recall = 0.0, [], []
    for batch in batches:
        image = torch.as_tensor(batch["image"], device=dev).permute(0, 3, 1, 2)
        out = forward(image)
        m = detection_eval_batch(out["class_logits"], out["bbox_deltas"],
                                 torch.as_tensor(batch["bboxes"], device=dev),
                                 torch.as_tensor(batch["labels"], device=dev),
                                 num_classes=num_classes, bbox_loss_weight=bbox_loss_weight)
        total_loss += float(m["loss"])
        has = m["has_match"].cpu().numpy()
        iou = m["sample_iou"].float().cpu().numpy()
        rec = m["sample_recall"].float().cpu().numpy()
        agg_iou.append(float(iou[has].mean()) if has.any() else 0.0)
        agg_recall.append(float(rec[has].mean()) if has.any() else 0.0)
    return {
        "val_loss": total_loss / max(1, len(agg_iou)),
        "avg_iou": float(np.mean(agg_iou)) if agg_iou else 0.0,
        "recall_0.5": float(np.mean(agg_recall)) if agg_recall else 0.0,
    }
