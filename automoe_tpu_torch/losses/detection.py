"""Detection set loss: matched CE + SmoothL1 (port of
automoe_tpu/losses/detection.py).

Dense per-cell outputs flatten to Q = h·w queries in the JAX package's
order (row-major over h, w); GT xyxy boxes become cxcywh before matching;
CE ignores unmatched queries (mean over matched ones); the bbox SmoothL1
(mean, or sum for the eval quirk) runs over matched queries, weighted by
bbox_loss_weight.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from automoe_tpu_torch.ops.boxes import box_convert
from automoe_tpu_torch.ops.masked import masked_cross_entropy, masked_smooth_l1


def get_matcher(name: str):
    """'hungarian' (exact on the tensors' device: K2 alone on the card,
    scipy on the CPU; ops/matching.py::exact_match), 'auction' (vectorised,
    greedy completion) or 'auction_kernel' (the CUDA auction with in-kernel
    exact JV escalation; its plain version on the CPU). The auction
    matchers take an iteration-cap suffix ('auction_kernel:256').
    'auction_pallas' is accepted as the JAX package's name of
    'auction_kernel'."""
    base, _, iters = name.partition(":")
    if iters and base == "hungarian":
        raise ValueError("hungarian matcher has no iteration cap")
    if base == "hungarian":
        from automoe_tpu_torch.ops.matching import exact_match

        return exact_match
    if base == "auction":
        from automoe_tpu_torch.ops.auction import auction_match as fn
    elif base in ("auction_kernel", "auction_pallas"):
        from automoe_tpu_torch.ops.auction_kernel import auction_match_kernel as fn
    else:
        raise ValueError(f"unknown matcher {name}")
    if iters:
        return functools.partial(fn, max_iters=int(iters))
    return fn


def scatter_matched_targets(query_idx: torch.Tensor, valid: torch.Tensor,
                            tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor,
                            num_queries: int, num_classes: int):
    """Per-query targets from per-target matches: target_classes [B,Q]
    (num_classes where unmatched) and target_boxes [B,Q,D] (zeros where
    unmatched). Invalid slots scatter to a scrap row (index Q), dropped."""
    B, N = query_idx.shape
    D = tgt_boxes.shape[-1]
    dev = query_idx.device
    to = torch.where(valid, query_idx, torch.full_like(query_idx, num_queries)).long()
    classes = torch.full((B, num_queries + 1), num_classes, dtype=torch.int32, device=dev)
    labels = torch.where(valid, tgt_labels, torch.full_like(tgt_labels, num_classes))
    classes.scatter_(1, to, labels.to(torch.int32))
    boxes = torch.zeros(B, num_queries + 1, D, dtype=torch.float32, device=dev)
    vals = torch.where(valid[..., None], tgt_boxes.float(), torch.zeros_like(tgt_boxes.float()))
    boxes.scatter_(1, to[..., None].expand(B, N, D), vals)
    return classes[:, :num_queries], boxes[:, :num_queries]


def detection_set_loss(class_logits: torch.Tensor, bbox_deltas: torch.Tensor,
                       gt_boxes_xyxy: torch.Tensor, gt_labels: torch.Tensor, *,
                       num_classes: int, bbox_loss_weight: float = 2.0,
                       cost_class: float = 1.0, cost_bbox: float = 5.0,
                       cost_giou: float = 2.0, bbox_reduction: str = "mean",
                       matcher: str = "hungarian") -> Dict[str, torch.Tensor]:
    """class_logits [B,C,h,w], bbox_deltas [B,4,h,w] (the port's NCHW expert
    outputs), gt_boxes_xyxy [B,N,4] padded with zeros, gt_labels [B,N]
    padded with -1."""
    B, C, h, w = class_logits.shape
    Q = h * w
    pred_logits = class_logits.permute(0, 2, 3, 1).reshape(B, Q, C)
    pred_boxes = bbox_deltas.permute(0, 2, 3, 1).reshape(B, Q, 4)
    tgt_cxcywh = box_convert(gt_boxes_xyxy.float(), "xyxy", "cxcywh")
    query_idx, valid = get_matcher(matcher)(  # every matcher runs without gradients
        pred_logits, pred_boxes, tgt_cxcywh, gt_labels,
        cost_class=cost_class, cost_bbox=cost_bbox, cost_giou=cost_giou)
    target_classes, target_boxes = scatter_matched_targets(
        query_idx, valid, tgt_cxcywh, gt_labels, Q, num_classes)
    class_loss = masked_cross_entropy(pred_logits.reshape(B * Q, C),
                                      target_classes.reshape(B * Q),
                                      ignore_index=num_classes)
    matched = target_classes.reshape(B * Q) != num_classes
    bbox_loss = masked_smooth_l1(pred_boxes.reshape(B * Q, 4),
                                 target_boxes.reshape(B * Q, 4), matched,
                                 reduction=bbox_reduction)
    return {
        "loss": class_loss + bbox_loss_weight * bbox_loss,
        "class_loss": class_loss,
        "bbox_loss": bbox_loss,
        "query_idx": query_idx,
        "valid": valid,
        "target_classes": target_classes,
        "target_boxes": target_boxes,
    }
