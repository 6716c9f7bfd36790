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

Under a mesh (`shard(mesh, stage_names)`) `step()` first reduces the
gradients over the ranks (parallel/mesh.py::Mesh.reduce_gradients) and
takes the clip's norm over the whole model: replicated parameters once,
a pipeline stage's squares summed over the model group.

`EMA` is the JAX TrainState's `ema_params`: an exponential moving average
of every parameter (frozen ones included), e ← e·d + p·(1−d) after each
optimizer step, started as a copy of the parameters (no bias
correction); BatchNorm statistics are not averaged. An optimizer made
with ema_decay > 0 owns one and updates it at the end of `step()`, as the
JAX package updates it inside `apply_gradients`, so every stepping mode
(single, steps per call, accumulation) carries it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Tuple

import torch


class EMA:
    """Exponential moving average of named parameters."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], decay: float):
        named = list(named_params)
        self.decay = float(decay)
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        # a real copy: the average must not alias the parameters
        self.shadow: List[torch.Tensor] = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def update(self) -> None:
        torch._foreach_mul_(self.shadow, self.decay)
        torch._foreach_add_(self.shadow, [p.detach() for p in self.params],
                            alpha=1.0 - self.decay)

    @torch.no_grad()
    def reset(self) -> None:
        """Start again at the parameters (after weights were loaded into them)."""
        torch._foreach_copy_(self.shadow, [p.detach() for p in self.params])

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The averages by parameter name (the live tensors)."""
        return dict(zip(self.names, self.shadow))

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        missing = sorted(set(self.names) - set(sd))
        if missing:
            raise KeyError(f"EMA state lacks {len(missing)} parameters: {missing[:5]}")
        torch._foreach_copy_(self.shadow, [sd[n].to(s.device, s.dtype)
                                           for n, s in zip(self.names, self.shadow)])

    @contextlib.contextmanager
    def applied(self) -> Iterator[None]:
        """The averages in the parameters' place for the block, the
        parameters restored bit for bit after it."""
        with torch.no_grad():
            saved = [p.detach().clone() for p in self.params]
            torch._foreach_copy_(self.params, self.shadow)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(self.params, saved)


class Optimizer:
    """optax-equivalent clip + AdamW/SGD over named parameters, stepped by
    `step()` from their `.grad`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], *,
                 learning_rate: float, weight_decay: float, total_steps: int,
                 grad_clip: float, eta_min: float, trainable_mask: Optional[Mapping[str, bool]],
                 schedule: str, optimizer: str, steps_per_epoch: int, ema_decay: float = 0.0):
        if schedule not in ("cosine", "constant", "cosine_per_epoch"):
            raise ValueError(f"unknown schedule {schedule}")
        if schedule == "cosine_per_epoch" and steps_per_epoch <= 0:
            raise ValueError("cosine_per_epoch needs steps_per_epoch > 0")
        if optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer}")
        mask = trainable_mask or {}
        named = list(named_params)
        self.params = [(n, p) for n, p in named if mask.get(n, True)]
        # the average covers every parameter, frozen ones too, as JAX's does
        self.ema = EMA(named, ema_decay) if ema_decay > 0.0 else None
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.total_steps = max(total_steps, 1)
        self.alpha = eta_min / learning_rate if learning_rate else 0.0
        self.grad_clip = grad_clip
        self.schedule = schedule
        self.optimizer = optimizer
        self.steps_per_epoch = steps_per_epoch
        self.count = 0  # optimizer steps taken (optax's schedule count)
        self.mesh = None  # set by shard(): gradients reduced over its ranks
        self.stage_local: List[bool] = [False] * len(self.params)
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

    def shard(self, mesh, stage_names=()) -> None:
        """Reduce gradients over `mesh` in every step; `stage_names` are the
        parameters that live on their pipeline stage's ranks only."""
        from automoe_tpu_torch.parallel.mesh import named_stage_local

        self.mesh = mesh
        self.stage_local = named_stage_local(self.params, stage_names)

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in self.params]
        if self.mesh is not None:
            self.mesh.reduce_gradients(grads, self.stage_local)
        if grads:
            norm = torch.sqrt(self.mesh.grad_norm_sq(grads, self.stage_local)
                              if self.mesh is not None
                              else sum((g.float() * g.float()).sum() for g in grads))
            clip = norm >= self.grad_clip
            grads = [torch.where(clip, g / norm * self.grad_clip, g) for g in grads]
        step_size = -self.lr_at(self.count)
        self.count += 1
        if self.optimizer == "sgd":
            for (_, p), g in zip(self.params, grads):
                p.add_(step_size * g)
        else:
            self._adamw(grads, step_size)
        if self.ema is not None:
            self.ema.update()

    def _adamw(self, grads, step_size: float) -> None:
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
                   steps_per_epoch: int = 0, ema_decay: float = 0.0) -> Optimizer:
    """The JAX package's optimizer over `named_params` (e.g.
    model.named_parameters()); trainable_mask maps a parameter name to
    False to freeze it; ema_decay > 0 keeps an `EMA` of every parameter
    (`Optimizer.ema`)."""
    return Optimizer(named_params, learning_rate=learning_rate, weight_decay=weight_decay,
                     total_steps=total_steps, grad_clip=grad_clip, eta_min=eta_min,
                     trainable_mask=trainable_mask, schedule=schedule, optimizer=optimizer,
                     steps_per_epoch=steps_per_epoch, ema_decay=ema_decay)
