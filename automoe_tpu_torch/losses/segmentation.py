"""Segmentation / drivable-area loss: CE with ignore index 255 (port of
automoe_tpu/losses/segmentation.py).

Logits are the port's NCHW [B,C,H,W]; masks are [B,H,W] int with 255 =
ignore. The CE runs over dim 1, the mean over the pixels not ignored."""
from __future__ import annotations

from typing import Dict

import torch

from automoe_tpu_torch.ops.masked import masked_cross_entropy

IGNORE_INDEX = 255


def segmentation_loss(logits: torch.Tensor, masks: torch.Tensor, *,
                      ignore_index: int = IGNORE_INDEX) -> Dict[str, torch.Tensor]:
    # labels outside [0, C) other than ignore_index are ignored too, at
    # loss time, as the reference CARLA fine-tune does: a cache written
    # without the datasets' load-time remap still trains correctly
    C = logits.shape[1]
    invalid = (masks < 0) | ((masks >= C) & (masks != ignore_index))
    masks = torch.where(invalid, torch.full_like(masks, ignore_index), masks)
    return {"loss": masked_cross_entropy(logits, masks, ignore_index=ignore_index, dim=1)}
