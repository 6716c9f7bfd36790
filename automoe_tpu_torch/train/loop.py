"""Training loop (port of automoe_tpu/train/loop.py: TrainConfig and the
Trainer's single-step epoch, validation, checkpointing, resume and fit).

Epoch structure as in the JAX package: the loader reshuffles per epoch,
the train loss is the mean over the epoch's steps, validation averages
each scalar metric over batches (a repeat-padded tail batch is trimmed
to its real rows and weighted by its real fraction), each epoch logs
to runs/<workload>_<run>/metrics.jsonl, and each epoch ends in
`CheckpointManager.save_epoch` under <ckpt_root>/<workload>/<run>/.
Batches go host→device from pinned memory with non_blocking copies. The
step's metrics are read back and logged every step (the JAX Trainer logs
every `log_every` steps). The gradient clip is the JAX package's default,
global norm 1.0.

Resume as in the JAX Trainer: resume='model' loads weights and BatchNorm
statistics and starts at epoch 0; resume='full' also loads the optimizer
(step count, moments, hence the schedule's position) and continues after
the restored epoch, or, from a `step` checkpoint, inside it: the loader
skips the consumed batches at the index level.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from automoe_tpu_torch.ckpt.checkpoint import CheckpointManager
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
    ckpt_root: str = "checkpoints"
    runs_root: str = "runs"
    save_freq: int = 0  # N>0 also writes epoch_N every N epochs
    keep_epochs: int = 0  # keep the newest K epoch_N files (0 = all)
    # write checkpoints from a background thread (the host snapshot stays
    # synchronous); fit() waits for the last write
    async_ckpt: bool = False
    resume: Optional[str] = None  # 'model' | 'full'
    resume_from: str = "last"  # best | last | epoch_N | step
    # N>0 writes a mid-epoch `step` checkpoint every N optimizer steps
    save_every_steps: int = 0
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
            optimizer=config.optimizer, trainable_mask=workload.trainable_mask(self.model),
            schedule=config.schedule, steps_per_epoch=batches_per_epoch)
        self.train_step = make_train_step(workload.loss_fn)
        self.eval_step = make_eval_step(workload.loss_fn)
        self.ckpt = CheckpointManager(config.ckpt_root, workload.name, config.run_name,
                                      save_freq=config.save_freq,
                                      async_save=config.async_ckpt, keep=config.keep_epochs)
        self.logger = MetricsLogger(f"{config.runs_root}/{workload.name}_{config.run_name}")
        self.timer = StepTimer(self.device)
        self.start_epoch = 0
        self.start_batch = 0  # batches of start_epoch already consumed
        self.resumed = False  # True only if a checkpoint was loaded
        if config.resume:
            epoch, batch_index = self.ckpt.restore(self.model, self.optimizer,
                                                   which=config.resume_from, mode=config.resume)
            if config.resume == "full":
                if config.resume_from == "step":
                    self.start_epoch, self.start_batch = epoch, batch_index
                else:
                    self.start_epoch = epoch + 1
            self.resumed = self.ckpt.last_restore_loaded
        self._step_save_marker = 0

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

    def _set_epoch_with_skip(self, epoch: int) -> tuple[int, int]:
        """Reshuffle for `epoch` and, when resuming it mid-way, skip the
        consumed batches: in the sampler's index stream where the loader
        has one (nothing is decoded for them), else by discarding them in
        the loop. Returns (batches accounted before the loop's first,
        batches to discard in the loop)."""
        skip = self.start_batch if epoch == self.start_epoch else 0
        set_epoch = getattr(self.train_loader, "set_epoch", None)
        if set_epoch is None:  # a plain iterable of batches
            return 0, skip
        set_epoch(epoch, skip_batches=skip)
        return skip, 0

    def _maybe_save_step(self, epoch: int, consumed: int) -> None:
        """Write the `step` checkpoint when `consumed` batches cross a
        save_every_steps boundary."""
        s = self.cfg.save_every_steps
        if s and consumed // s > self._step_save_marker:
            self._step_save_marker = consumed // s
            self.ckpt.save_step(self.model, self.optimizer, epoch, consumed)

    def train_epoch(self, epoch: int) -> float:
        s = self.cfg.save_every_steps
        self._step_save_marker = (self.start_batch // s
                                  if s and epoch == self.start_epoch else 0)
        consumed0, skip_in_loop = self._set_epoch_with_skip(epoch)
        total, n = 0.0, 0
        t0 = time.time()
        for i, batch in enumerate(self.train_loader):
            if i < skip_in_loop:
                continue
            db = self._device_batch(batch)
            # dropout draws from torch's global generator: seed it from
            # (seed, step), as the JAX step folds the step into its dropout
            # key, so a resumed run draws the masks of an uninterrupted one
            torch.manual_seed(int(np.random.SeedSequence(
                (self.cfg.seed + 1, self.optimizer.count)).generate_state(1)[0]))
            self.timer.start()
            metrics = self.train_step(self.model, self.optimizer, db)
            self.timer.stop()
            # one device→host copy for all of the step's scalars
            scalars = dict(zip(metrics, torch.stack([v.float() for v in metrics.values()])
                               .tolist()))
            total += scalars["loss"]
            n += 1
            self.logger.log(self.optimizer.count, scalars, prefix="train")
            self._maybe_save_step(epoch, consumed0 + i + 1)
        avg = total / max(1, n)
        dt = time.time() - t0
        self.logger.log(self.optimizer.count, {"loss_epoch": avg, "epoch_seconds": dt,
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
        self.logger.log(self.optimizer.count, avg, prefix="val")
        return avg.get("loss", float("inf"))

    def fit(self, config_dump: Optional[Dict] = None) -> Dict[str, float]:
        """Train, validate and checkpoint every epoch from start_epoch;
        config_dump (default: the TrainConfig) goes to config.json beside
        the checkpoints. Returns the best val loss (a resumed run's
        included) and the train step-time statistics (device time on
        CUDA)."""
        config_dump = config_dump if config_dump is not None else dataclasses.asdict(self.cfg)
        best = self.ckpt.best_val
        for epoch in range(self.start_epoch, self.cfg.epochs):
            train_loss = self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            is_best = self.ckpt.save_epoch(self.model, self.optimizer, epoch, val_loss,
                                           config_dump)
            best = min(best, val_loss)
            print(f"[{self.wl.name}] epoch {epoch + 1}/{self.cfg.epochs} "
                  f"train {train_loss:.4f} val {val_loss:.4f}" + (" *best*" if is_best else ""),
                  flush=True)
        self.ckpt.wait()  # queued writes land before callers read them
        stats = self.timer.stats()
        self.logger.log(self.optimizer.count, stats, prefix="train")
        self.logger.close()
        return {"best_val_loss": best, **stats}
