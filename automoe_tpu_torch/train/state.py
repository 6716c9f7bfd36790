"""Optimizer factory (port of automoe_tpu/train/state.py::make_optimizer).

The JAX package chains optax's `clip_by_global_norm(grad_clip)` with
`adamw(lr, weight_decay)` or `sgd(lr)`, under a schedule of one of three
cadences, and freezes parameter groups with zero updates. `Optimizer`
below is that chain written out in PyTorch with optax's arithmetic:

* clip: g / norm * max_norm when norm >= max_norm (no 1e-6 added to the
  norm, unlike torch.nn.utils.clip_grad_norm_), the norm over trainable
  parameters only;
* AdamW: b1 0.9, b2 0.999, eps 1e-8, bias-corrected moments, decoupled
  decay on every trainable parameter, then -lr;
* SGD: -lr · g (no momentum, no decay);
* schedules: 'cosine' is optax's closed form at the pre-increment count,
  lr·((1−α)·½(1+cos(π·min(t,T)/T))+α) with T = total_steps (not
  CosineAnnealingLR's recursion); 'constant'; 'cosine_per_epoch' takes
  the cosine at t // steps_per_epoch;
* frozen parameters (trainable_mask False) get zero updates and no state.

`state_dict()` / `load_state_dict()` carry the step count and the moments,
so a resumed run continues the same trajectory, schedule included.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch


class Optimizer:
    """optax-equivalent clip + AdamW/SGD over named parameters, stepped by
    `step()` from their `.grad`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], *,
                 learning_rate: float, weight_decay: float, total_steps: int,
                 grad_clip: float, eta_min: float, trainable_mask: Optional[Mapping[str, bool]],
                 schedule: str, optimizer: str, steps_per_epoch: int):
        if schedule not in ("cosine", "constant", "cosine_per_epoch"):
            raise ValueError(f"unknown schedule {schedule}")
        if schedule == "cosine_per_epoch" and steps_per_epoch <= 0:
            raise ValueError("cosine_per_epoch needs steps_per_epoch > 0")
        if optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer}")
        mask = trainable_mask or {}
        self.params = [(n, p) for n, p in named_params if mask.get(n, True)]
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.total_steps = max(total_steps, 1)
        self.alpha = eta_min / learning_rate if learning_rate else 0.0
        self.grad_clip = grad_clip
        self.schedule = schedule
        self.optimizer = optimizer
        self.steps_per_epoch = steps_per_epoch
        self.count = 0  # optimizer steps taken (optax's schedule count)
        self.state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        if optimizer == "adamw":
            self.state = {n: (torch.zeros_like(p), torch.zeros_like(p)) for n, p in self.params}

    def lr_at(self, count: int) -> float:
        """The schedule's value at optimizer step `count`, in f32 as optax
        evaluates it."""
        if self.schedule == "constant":
            return self.learning_rate
        if self.schedule == "cosine_per_epoch":
            count = count // self.steps_per_epoch
        t = torch.tensor(float(min(count, self.total_steps)), dtype=torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * t / float(self.total_steps)))
        return float(self.learning_rate * ((1 - self.alpha) * cosine + self.alpha))

    def state_dict(self) -> Dict:
        """The step count (which fixes the schedule's position) and the AdamW
        moments of the trainable parameters, by parameter name. The tensors
        are the live ones: copy them before the next step if they must keep."""
        return {"count": self.count, "state": dict(self.state)}

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping) -> None:
        """Continue from `sd` (a `state_dict()` of an optimizer over the
        same trainable parameters)."""
        if set(sd["state"]) != set(self.state):
            raise KeyError("optimizer state names differ: "
                           f"{sorted(set(sd['state']) ^ set(self.state))[:5]}")
        for n, (mu, nu) in self.state.items():
            mu.copy_(sd["state"][n][0])
            nu.copy_(sd["state"][n][1])
        self.count = int(sd["count"])

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in self.params]
        if grads:
            norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
            clip = norm >= self.grad_clip
            grads = [torch.where(clip, g / norm * self.grad_clip, g) for g in grads]
        step_size = -self.lr_at(self.count)
        self.count += 1
        if self.optimizer == "sgd":
            for (_, p), g in zip(self.params, grads):
                p.add_(step_size * g)
            return
        b1, b2, eps = 0.9, 0.999, 1e-8
        c = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
        for (n, p), g in zip(self.params, grads):
            mu, nu = self.state[n]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            u = u + self.weight_decay * p
            p.add_(step_size * u)


def make_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]], *,
                   learning_rate: float, weight_decay: float = 1e-4, total_steps: int,
                   grad_clip: float = 1.0, eta_min: float = 0.0,
                   trainable_mask: Optional[Mapping[str, bool]] = None,
                   schedule: str = "cosine", optimizer: str = "adamw",
                   steps_per_epoch: int = 0) -> Optimizer:
    """The JAX package's optimizer over `named_params` (e.g.
    model.named_parameters()); trainable_mask maps a parameter name to
    False to freeze it."""
    return Optimizer(named_params, learning_rate=learning_rate, weight_decay=weight_decay,
                     total_steps=total_steps, grad_clip=grad_clip, eta_min=eta_min,
                     trainable_mask=trainable_mask, schedule=schedule, optimizer=optimizer,
                     steps_per_epoch=steps_per_epoch)
