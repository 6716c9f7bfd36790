"""Training loop (port of automoe_tpu/train/loop.py: TrainConfig and the
Trainer's single-step epoch, validation and fit).

Epoch structure as in the JAX package: the loader reshuffles per epoch,
the train loss is the mean over the epoch's steps, validation averages
each scalar metric over batches (a repeat-padded tail batch is trimmed
to its real rows and weighted by its real fraction), and each epoch logs
to runs/<workload>_<run>/metrics.jsonl. Batches go host→device from
pinned memory with non_blocking copies. The step's metrics are read back
and logged every step (the JAX Trainer logs every `log_every` steps).
The gradient clip is the JAX package's default, global norm 1.0.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from automoe_tpu_torch.train.state import make_optimizer
from automoe_tpu_torch.train.step import make_eval_step, make_train_step
from automoe_tpu_torch.train.workloads import Workload
from automoe_tpu_torch.utils import resolve_device
from automoe_tpu_torch.utils.metrics import MetricsLogger
from automoe_tpu_torch.utils.profiling import StepTimer


@dataclass
class TrainConfig:
    epochs: int = 1
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    optimizer: str = "adamw"  # 'adamw' | 'sgd'
    schedule: str = "cosine"  # 'cosine' | 'constant' | 'cosine_per_epoch'
    seed: int = 0
    run_name: str = "run"
    runs_root: str = "runs"
    device: Optional[str] = None  # default cuda


class Trainer:
    def __init__(self, workload: Workload, train_loader, val_loader, config: TrainConfig):
        self.wl = workload
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.cfg = config
        self.device = resolve_device(config.device)
        self.model = workload.init_model(config.seed, self.device)
        batches_per_epoch = max(1, len(train_loader))
        self.optimizer = make_optimizer(
            self.model.named_parameters(), learning_rate=config.learning_rate,
            weight_decay=config.weight_decay, total_steps=config.epochs * batches_per_epoch,
            optimizer=config.optimizer,
            schedule=config.schedule, steps_per_epoch=batches_per_epoch)
        self.train_step = make_train_step(workload.loss_fn)
        self.eval_step = make_eval_step(workload.loss_fn)
        self.logger = MetricsLogger(f"{config.runs_root}/{workload.name}_{config.run_name}")
        self.timer = StepTimer(self.device)
        self._host_step = 0

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            if isinstance(v, list) or k == "_real_count":
                continue
            t = torch.as_tensor(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def train_epoch(self, epoch: int) -> float:
        set_epoch = getattr(self.train_loader, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
        total, n = 0.0, 0
        t0 = time.time()
        for batch in self.train_loader:
            db = self._device_batch(batch)
            self.timer.start()
            metrics = self.train_step(self.model, self.optimizer, db)
            self.timer.stop()
            # one device→host copy for all of the step's scalars
            scalars = dict(zip(metrics, torch.stack([v.float() for v in metrics.values()])
                               .tolist()))
            total += scalars["loss"]
            n += 1
            self._host_step += 1
            self.logger.log(self._host_step, scalars, prefix="train")
        avg = total / max(1, n)
        dt = time.time() - t0
        self.logger.log(self._host_step, {"loss_epoch": avg, "epoch_seconds": dt,
                                          "steps_per_sec": n / max(dt, 1e-9)}, prefix="train")
        return avg

    def validate(self, epoch: int) -> float:
        sums: Dict[str, float] = {}
        n = 0.0
        for batch in self.val_loader:
            real = batch.get("_real_count") if isinstance(batch, dict) else None
            db = self._device_batch(batch)
            w = 1.0
            if real is not None:
                real = int(real)
                w = real / max(1, next(iter(db.values())).shape[0])
                db = {k: v[:real] for k, v in db.items()}
            metrics = self.eval_step(self.model, db)
            for k, v in metrics.items():
                if getattr(v, "ndim", 1) == 0 or isinstance(v, (int, float)):
                    sums[k] = sums.get(k, 0.0) + float(v) * w
            n += w
        denom = n if n > 0 else 1.0
        avg = {k: v / denom for k, v in sums.items()}
        self.logger.log(self._host_step, avg, prefix="val")
        return avg.get("loss", float("inf"))

    def fit(self) -> Dict[str, float]:
        """Train and validate every epoch. Returns the best val loss and
        the train step-time statistics (device time on CUDA)."""
        best = float("inf")
        for epoch in range(self.cfg.epochs):
            train_loss = self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            best = min(best, val_loss)
            print(f"[{self.wl.name}] epoch {epoch + 1}/{self.cfg.epochs} "
                  f"train {train_loss:.4f} val {val_loss:.4f}", flush=True)
        stats = self.timer.stats()
        self.logger.log(self._host_step, stats, prefix="train")
        self.logger.close()
        return {"best_val_loss": best, **stats}
