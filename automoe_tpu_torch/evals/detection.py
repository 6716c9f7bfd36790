"""Detection metrics from an existing assignment (port of
automoe_tpu/evals/detection.py::matched_iou_recall)."""
from __future__ import annotations

import torch

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
