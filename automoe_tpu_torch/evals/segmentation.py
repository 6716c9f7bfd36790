"""Segmentation / drivable evaluation: val loss, pixel accuracy, mean IoU
(port of automoe_tpu/evals/segmentation.py).

Per batch: pixel accuracy over the pixels not ignored (255); mean IoU
over the classes present in the ground truth, the union leaving ignored
pixels out; both averaged over batches. The counts come from one
confusion histogram (a scatter-add, no host synchronisation) and equal
the JAX package's one-hot sums.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from automoe_tpu_torch.evals.common import Forward, as_forward
from automoe_tpu_torch.losses.segmentation import IGNORE_INDEX, segmentation_loss


def seg_metrics(logits: torch.Tensor, masks: torch.Tensor, *,
                num_classes: int) -> Dict[str, torch.Tensor]:
    """logits [B,C,H,W], masks [B,H,W] → {pixel_acc, mean_iou} (0-dim f32)."""
    C = num_classes
    preds = logits.argmax(dim=1).long()
    gt = masks.long()
    valid = gt != IGNORE_INDEX
    # rows: the GT class, C for a valid label outside [0, C); cols: the
    # prediction; ignored pixels go to one scrap bin past the table
    row = torch.where((gt >= 0) & (gt < C), gt, torch.full_like(gt, C))
    idx = torch.where(valid, row * C + preds, torch.full_like(gt, (C + 1) * C)).reshape(-1)
    hist = torch.zeros((C + 1) * C + 1, dtype=torch.int64, device=idx.device)
    hist.scatter_add_(0, idx, torch.ones_like(idx))
    conf = hist[:-1].reshape(C + 1, C)
    inter = torch.diagonal(conf[:C]).float()
    gt_count = conf[:C].sum(1)
    union = (gt_count + conf.sum(0)).float() - inter
    pixel_acc = torch.diagonal(conf[:C]).sum() / torch.clamp(conf.sum(), min=1)
    countable = (gt_count > 0) & (union > 0)
    iou = torch.where(countable, inter / torch.clamp(union, min=1.0), torch.zeros_like(inter))
    mean_iou = iou.sum() / torch.clamp(countable.sum(), min=1)
    return {"pixel_acc": pixel_acc.float(), "mean_iou": mean_iou}


@torch.no_grad()
def seg_eval_batch(logits: torch.Tensor, masks: torch.Tensor, *,
                   num_classes: int) -> Dict[str, torch.Tensor]:
    loss = segmentation_loss(logits, masks)["loss"]
    return {"loss": loss, **seg_metrics(logits, masks, num_classes=num_classes)}


@torch.no_grad()
def evaluate_seg_like(model: Forward, batches: Iterable, *, num_classes: int,
                      device=None) -> Dict[str, float]:
    """`model` maps an NCHW image to [B,C,H,W] logits: the module in eval
    mode on its device, or a callable (the int8 forward) with `device`.
    Over numpy batches (NHWC images, [B,H,W] masks): the means over
    batches."""
    forward, device = as_forward(model, device)
    total_loss, accs, ious = 0.0, [], []
    for batch in batches:
        image = torch.as_tensor(batch["image"], device=device).permute(0, 3, 1, 2)
        m = seg_eval_batch(forward(image),
                           torch.as_tensor(batch["mask"], device=device),
                           num_classes=num_classes)
        total_loss += float(m["loss"])
        accs.append(float(m["pixel_acc"]))
        ious.append(float(m["mean_iou"]))
    n = max(1, len(accs))
    return {
        "val_loss": total_loss / n,
        "pixel_acc": float(np.mean(accs)) if accs else 0.0,
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
    }
