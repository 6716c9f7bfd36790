"""Masked reductions (port of automoe_tpu/ops/masked.py).

Written as the JAX package writes them: a `where`-masked sum over a mean
with max(count, 1), so a batch with nothing matched gives 0, not the NaN
that `F.cross_entropy(ignore_index=...)` or a loss over an empty
boolean-indexed tensor would give. Under a data-parallel mesh the count is
the data group's (`parallel.mesh.loss_denominator`): each rank divides its
local sum by the mean count, so the ranks' mean is the global batch's mean
even when they match different numbers of queries.
"""
from __future__ import annotations

import torch

from automoe_tpu_torch.parallel.mesh import loss_denominator


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int, dim: int = -1) -> torch.Tensor:
    """Mean CE over positions whose label != ignore_index. logits hold
    the classes on `dim` ([..., C] by default, [B,C,H,W] with dim=1);
    labels are the logits' shape without that dim, int."""
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=dim)
    nll = -torch.gather(logp, dim, safe.unsqueeze(dim)).squeeze(dim)
    denom = loss_denominator(mask.sum())
    return torch.where(mask, nll, torch.zeros_like(nll)).sum() / denom


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise SmoothL1 (Huber with beta), as torch.nn.SmoothL1Loss."""
    diff = torch.abs(pred.float() - target.float())
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def masked_smooth_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, *,
                     reduction: str = "mean", beta: float = 1.0) -> torch.Tensor:
    """SmoothL1 over masked rows; mask broadcasts over trailing dims.
    'mean' averages over all elements of the selected rows, 'sum' sums."""
    per_elem = smooth_l1(pred, target, beta)
    m = mask[..., None].to(per_elem.dtype).expand(per_elem.shape)
    total = (per_elem * m).sum()
    if reduction == "sum":
        return total
    return total / loss_denominator(m.sum())
