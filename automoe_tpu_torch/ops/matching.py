"""DETR-style set matching (port of automoe_tpu/ops/matching.py).

`match_cost_matrix` is the JAX package's cost, written over leading batch
dims. `hungarian_match` is exact: scipy's `linear_sum_assignment` on the
host copy of the cost matrix, and the tests' oracle. `exact_match` is the
matcher name 'hungarian' (the JAX package's on-device optax Hungarian):
exact on the tensors' own device, K2 alone on the card, scipy on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from automoe_tpu_torch.ops.boxes import bev_from_3d, box_convert, generalized_box_iou

#: Row-uniform cost of padded (invalid) target columns; uniformity over
#: rows keeps the real columns' optimal assignment unchanged.
_PAD_COST = 1e6


def match_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor, *,
                      cost_class: float = 1.0, cost_bbox: float = 5.0,
                      cost_giou: float = 2.0) -> torch.Tensor:
    """[..., Q,C], [..., Q,D], [..., N,D], [..., N] -> [..., Q,N].

    cost_bbox·L1 + cost_class·(−softmax prob of the target class) +
    cost_giou·(−GIoU): 2D GIoU for D == 4 (cxcywh), axis-aligned BEV GIoU
    for D == 7. Padded targets (label < 0) take the sentinel _PAD_COST."""
    valid = tgt_labels >= 0
    labels = torch.clamp(tgt_labels, min=0).long()
    prob = torch.softmax(pred_logits.float(), dim=-1)
    Q, N = prob.shape[-2], labels.shape[-1]
    idx = labels.unsqueeze(-2).expand(*prob.shape[:-1], N)
    c_class = -torch.gather(prob, -1, idx)
    pb, tb = pred_boxes.float(), tgt_boxes.float()
    c_bbox = torch.abs(pb[..., :, None, :] - tb[..., None, :, :]).sum(-1)
    d = pred_boxes.shape[-1]
    if cost_giou > 0 and d == 4:
        c_giou = -generalized_box_iou(box_convert(pb, "cxcywh", "xyxy"),
                                      box_convert(tb, "cxcywh", "xyxy"))
    elif cost_giou > 0 and d == 7:
        c_giou = -generalized_box_iou(bev_from_3d(pb), bev_from_3d(tb))
    else:
        c_giou = torch.zeros_like(c_bbox)
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    return torch.where(valid.unsqueeze(-2), cost, torch.full_like(cost, _PAD_COST))


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor, *,
                    cost_class: float = 1.0, cost_bbox: float = 5.0,
                    cost_giou: float = 2.0):
    """Exact batched matching. [B,Q,C], [B,Q,D], [B,N,D], [B,N] →
    (query_idx [B,N] int32: the query matched to each target slot,
    valid [B,N] bool: the slot is a real target). Requires N <= Q."""
    from scipy.optimize import linear_sum_assignment

    B, Q, _ = pred_logits.shape
    N = tgt_labels.shape[1]
    if N > Q:
        raise ValueError(f"target cap N={N} exceeds query count Q={Q}")
    cost = match_cost_matrix(pred_logits, pred_boxes, tgt_boxes, tgt_labels,
                             cost_class=cost_class, cost_bbox=cost_bbox,
                             cost_giou=cost_giou)
    cost = cost.cpu().numpy().astype(np.float64)
    query_idx = np.zeros((B, N), np.int32)
    for b in range(B):
        rows, cols = linear_sum_assignment(cost[b])
        query_idx[b, cols] = rows
    return (torch.from_numpy(query_idx).to(tgt_labels.device), tgt_labels >= 0)


@torch.no_grad()
def exact_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor, **costs):
    """Exact matching where the tensors lie: on the card the CUDA kernel's
    exact JV alone (`auction_match_kernel(max_iters=0)`: no auction rounds,
    every element through K2, no host copy), on the CPU `hungarian_match`.
    Both are exact; they can differ only on exact cost ties."""
    if pred_logits.is_cuda:
        from automoe_tpu_torch.ops.auction_kernel import auction_match_kernel

        return auction_match_kernel(pred_logits, pred_boxes, tgt_boxes, tgt_labels,
                                    max_iters=0, **costs)
    return hungarian_match(pred_logits, pred_boxes, tgt_boxes, tgt_labels, **costs)
