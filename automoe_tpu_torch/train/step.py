"""Single-device train and eval steps (port of automoe_tpu/train/step.py:
the single-step body `_train_body` and `make_eval_step`)."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from automoe_tpu_torch.train.state import Optimizer
from automoe_tpu_torch.train.workloads import LossFn


def make_train_step(loss_fn: LossFn):
    """One optimizer step: forward in train mode (BatchNorm on batch
    statistics, running stats updated), loss with the matching under
    no_grad, backward, global-norm clip, optimizer and schedule step.
    Returns the step's metrics (detached, on the device), loss included."""

    def train_step(model: nn.Module, optimizer: Optimizer,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        loss, metrics = loss_fn(model, batch, True)
        loss.backward()
        optimizer.step()
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return out

    return train_step


def make_eval_step(loss_fn: LossFn):
    """Loss and metrics in eval mode (BatchNorm on running statistics)."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        loss, metrics = loss_fn(model, batch, False)
        out = dict(metrics)
        out["loss"] = loss
        return out

    return eval_step
