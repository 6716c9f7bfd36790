"""nuScenes expert evaluation: the matched CE + SmoothL1 val loss (port of
automoe_tpu/evals/nuscenes.py). It matches exactly, as the JAX default
does: the loss's 'hungarian' matcher, K2 alone on the card and scipy on
the CPU, so a model on the card is matched there."""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from automoe_tpu_torch.evals.common import Forward, as_forward
from automoe_tpu_torch.losses.nuscenes import nuscenes_set_loss


@torch.no_grad()
def evaluate_nuscenes(model: Forward, batches: Iterable, *, bbox_loss_weight: float = 5.0,
                      device=None) -> Dict[str, float]:
    """`model` maps (NCHW image, [B,P,3] points) to {class_logits,
    bbox_preds}: the module in eval mode on its device, or a callable with
    `device`. Over numpy batches (NHWC images, [B,P,3] points, [B,M,7]
    boxes, [B,M] labels)."""
    forward, device = as_forward(model, device)
    total, n = 0.0, 0
    for batch in batches:
        t = {k: torch.as_tensor(batch[k], device=device)
             for k in ("image", "lidar", "boxes", "labels")}
        out = forward(t["image"].permute(0, 3, 1, 2), t["lidar"])
        res = nuscenes_set_loss(out["class_logits"], out["bbox_preds"], t["boxes"],
                                t["labels"], bbox_loss_weight=bbox_loss_weight)
        total += float(res["loss"])
        n += 1
    return {"val_loss": total / max(1, n)}
