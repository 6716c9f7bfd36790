"""Single-device train and eval steps (port of automoe_tpu/train/step.py:
the single step `_train_body`, `make_scan_train_step`,
`make_indexed_scan_train_step`, `make_grad_accum_train_step` and
`make_eval_step`).

A step's randomness comes from a key, a tuple of ints: the loop passes
(seed + 1, optimizer steps taken), as the JAX step folds its step count
into its key. `seed_from(key)` seeds torch's generators from it before the
forward (dropout), and the loss function gets the key for what it draws
itself (augmentation). So K steps in one call draw what K single steps
draw, and a resumed run draws what an unbroken one does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from automoe_tpu_torch.train.state import Optimizer
from automoe_tpu_torch.train.workloads import LossFn

Key = Tuple[int, ...]


def seed_from(key: Key) -> int:
    """A 32-bit seed from a key of non-negative ints."""
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def _forward(loss_fn: LossFn, model: nn.Module, batch, key: Optional[Key]):
    if key is not None:
        torch.manual_seed(seed_from(key))  # dropout
    return loss_fn(model, batch, True, key)


def make_train_step(loss_fn: LossFn):
    """One optimizer step: forward in train mode (BatchNorm on batch
    statistics, running stats updated), loss with the matching under
    no_grad, backward, global-norm clip, optimizer and schedule step (and
    the optimizer's EMA). Returns the step's metrics (detached, on the
    device), loss included."""

    def train_step(model: nn.Module, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
                   key: Optional[Key] = None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        loss, metrics = _forward(loss_fn, model, batch, key)
        loss.backward()
        optimizer.step()
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        return out

    return train_step


def make_scan_train_step(loss_fn: LossFn):
    """K optimizer steps in one call over a stacked batch ([K, B, ...]
    tensors, one host→device copy): step i takes batch i with key
    (*key[:-1], key[-1] + i), so the result is K single steps'. Returns
    each metric stacked over the K steps ([K], on the device: one
    read-back serves all K)."""
    step = make_train_step(loss_fn)

    def scan_step(model: nn.Module, optimizer: Optimizer, batches: Dict[str, torch.Tensor],
                  key: Optional[Key] = None) -> Dict[str, torch.Tensor]:
        k = next(iter(batches.values())).shape[0]
        outs: List[Dict[str, torch.Tensor]] = []
        for i in range(k):
            ki = None if key is None else (*key[:-1], key[-1] + i)
            outs.append(step(model, optimizer, {n: v[i] for n, v in batches.items()}, ki))
        return {n: torch.stack([o[n] for o in outs]) for n in outs[0]}

    return scan_step


def make_indexed_scan_train_step(loss_fn: LossFn, k: int):
    """`make_scan_train_step` that takes its K batches out of a resident
    epoch itself (the JAX package's make_indexed_scan_train_step): the
    caller passes the loader's flat [S, B, ...] epoch and a base index g0,
    and step i trains on batch g0 + i with key (*key[:-1], key[-1] + i),
    so the result is the grouped call's on the same batches. No [K, B, ...]
    copy of the group is made."""
    step = make_train_step(loss_fn)

    def indexed_step(model: nn.Module, optimizer: Optimizer,
                     epoch_batches: Dict[str, torch.Tensor], g0: int,
                     key: Optional[Key] = None) -> Dict[str, torch.Tensor]:
        outs: List[Dict[str, torch.Tensor]] = []
        for i in range(k):
            ki = None if key is None else (*key[:-1], key[-1] + i)
            outs.append(step(model, optimizer, {n: v[g0 + i] for n, v in epoch_batches.items()},
                             ki))
        return {n: torch.stack([o[n] for o in outs]) for n in outs[0]}

    return indexed_step


def make_grad_accum_train_step(loss_fn: LossFn):
    """One optimizer step from K microbatches ([K, B, ...] tensors): the
    gradients of the K microbatch losses are summed in order and their
    mean applied once, so the effective batch is K·B with one
    microbatch's activations live at a time. Each microbatch is
    normalised by its own BatchNorm statistics and moves the running
    statistics in turn (the JAX package's and torch's accumulation
    semantics); microbatch i draws from key (*key, i). Returns the
    metrics averaged over the K microbatches."""

    def accum_step(model: nn.Module, optimizer: Optimizer, batches: Dict[str, torch.Tensor],
                   key: Optional[Key] = None) -> Dict[str, torch.Tensor]:
        k = next(iter(batches.values())).shape[0]
        model.train()
        optimizer.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        for i in range(k):
            loss, metrics = _forward(loss_fn, model, {n: v[i] for n, v in batches.items()},
                                     None if key is None else (*key, i))
            loss.backward()  # .grad accumulates the sum
            for n, v in {**metrics, "loss": loss}.items():
                v = v.detach()
                sums[n] = v if i == 0 else sums[n] + v
        with torch.no_grad():
            for _, p in optimizer.params:
                if p.grad is not None:
                    p.grad.div_(k)
        optimizer.step()
        return {n: v / k for n, v in sums.items()}

    return accum_step


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
