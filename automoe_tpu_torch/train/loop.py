"""Training loop (port of automoe_tpu/train/loop.py: TrainConfig and the
Trainer's epochs, grouped epochs, validation, checkpointing, resume and
fit).

Epoch structure as in the JAX package: the loader reshuffles per epoch,
the train loss is the mean over the epoch's losses, validation averages
each scalar metric over batches (a repeat-padded tail batch is trimmed
to its real rows and weighted by its real fraction), each epoch logs
to runs/<workload>_<run>/metrics.jsonl, and each epoch ends in
`CheckpointManager.save_epoch` under <ckpt_root>/<workload>/<run>/.
Batches go host→device from pinned memory with non_blocking copies.

Stepping modes, as in the JAX Trainer:
  * single steps (default);
  * steps_per_call K > 1: K loader batches stacked into one pinned
    buffer per key, one copy, K optimizer steps in one call
    (train/step.py::make_scan_train_step);
  * grad_accum K > 1: K loader batches, one optimizer step from their
    averaged gradients (make_grad_accum_train_step). The schedule then
    counts optimizer steps: len(loader) // K + len(loader) % K an epoch.
The two are exclusive. A tail of fewer than K batches runs as single
steps. A loader whose `group_size` equals K (the device-resident loader,
data/device_resident.py) yields its [K, B, ...] groups already stacked on
the card: each goes straight into the K-step call, and tensors already on
the card take no pinned copy. `rebind_train_loader` swaps in such a loader
after construction and rebuilds the schedule for its length.

The host never waits for a step it has just launched: at most
`max_inflight` losses stay unread on the device (0 reads every step's
loss at once), and step metrics are read and logged every `log_every`
optimizer steps. `debug_nans` runs the epochs under
torch.autograd.detect_anomaly and raises at the first non-finite loss
(reading every loss).

With ema_decay > 0 the optimizer keeps an EMA of the parameters
(train/state.py::EMA); each epoch validates it too (logged `val_ema`),
and it, not the raw weights, decides the best checkpoint. `profile_dir`
records a torch.profiler trace of the first trained epoch there.

Under a mesh of several ranks (`mesh=`, parallel/mesh.py), as the JAX
Trainer runs under its device mesh: every rank builds the model from the
same seed (a pipeline keeps its stage's blocks, parallel/pp.py), the
workload's BatchNorms normalise over the data group
(parallel/batchnorm.py) unless it says otherwise (expert parallelism),
`tp_min_dim` splits the wide weights over the 'model' group
(parallel/tp.py) and `spatial` the ResNet trunks' maps by height
(parallel/sp.py), with the JAX Trainer's refusals (`_mode_guards`),
the optimizer reduces the gradients over the ranks, each step's metrics
are averaged over them, validation sums each metric's sums and counts
over them exactly, and only rank 0 logs, prints and writes checkpoints
(in the single-process layout: pipeline stages and tensor-parallel slices
gathered whole). A mesh of one rank runs the single-process path
unchanged. A device-resident loader in `index_mode` yields base indices,
and its groups go through the indexed K-step call
(train/step.py::make_indexed_scan_train_step).

Resume as in the JAX Trainer: resume='model' loads weights and BatchNorm
statistics and starts at epoch 0; resume='full' also loads the optimizer
(step count, moments, hence the schedule's position) and continues after
the restored epoch, or, from a `step` checkpoint, inside it: the loader
skips the consumed batches at the index level.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from automoe_tpu_torch.ckpt.checkpoint import (
    CheckpointManager,
    StageLayout,
    load_state_into,
    state_dict_from_checkpoint,
)
from automoe_tpu_torch.train.state import make_optimizer
from automoe_tpu_torch.train.step import (
    make_eval_step,
    make_grad_accum_train_step,
    make_indexed_scan_train_step,
    make_scan_train_step,
    make_train_step,
)
from automoe_tpu_torch.train.workloads import Workload
from automoe_tpu_torch.utils import resolve_device
from automoe_tpu_torch.utils.metrics import MetricsLogger
from automoe_tpu_torch.utils.profiling import StepTimer


@dataclass
class TrainConfig:
    epochs: int = 1
    learning_rate: float = 2e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0  # global-norm clip
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
    log_every: int = 50  # log a step's metrics every N optimizer steps
    # losses left unread on the device before the host waits on the
    # oldest (0 = read every step's loss)
    max_inflight: int = 2
    steps_per_call: int = 1  # K>1: K optimizer steps per call
    profile_dir: Optional[str] = None  # torch.profiler trace of the first epoch
    # N>0 writes a mid-epoch `step` checkpoint every N loader batches
    save_every_steps: int = 0
    grad_accum: int = 1  # K>1: one optimizer step from K loader batches
    ema_decay: float = 0.0  # d>0: EMA of the parameters, validated and saved
    debug_nans: bool = False  # anomaly detection + raise on a non-finite loss
    device: Optional[str] = None  # default cuda; a mesh's device wins
    # M>0: the workload's model runs its trunk pipelined over the mesh's
    # 'model' group in M microbatches (workloads.policy_workload(
    # pipeline_mesh=, pipeline_microbatches=M))
    pp_microbatches: int = 0
    # N>0: parameters whose output dim is >= N and divides by the mesh's
    # 'model' axis are split over it (parallel/tp.py)
    tp_min_dim: int = 0
    # the ResNet trunks' maps split by height over the mesh's 'model' axis
    # (parallel/sp.py)
    spatial: bool = False


def _optimizer_steps_per_epoch(n_batches: int, grad_accum: int) -> int:
    """What the schedule counts an epoch: with grad_accum K, K batches
    make one step and the n % K tail batches one step each."""
    n = max(1, n_batches)
    return max(1, n // grad_accum + n % grad_accum) if grad_accum > 1 else n


def _mode_guards(config: TrainConfig, mesh) -> None:
    """The JAX Trainer's refusals for the modes that use the mesh's
    'model' axis, in its words."""
    shape = None if mesh is None else dict(mesh.shape)
    no_model = mesh is None or mesh.shape["model"] < 2
    if config.spatial:
        if no_model:
            raise ValueError("spatial partitioning needs a mesh with a 'model' axis > 1 "
                             f"(got {shape})")
        if config.steps_per_call > 1:
            raise ValueError("spatial partitioning and steps_per_call > 1 are exclusive "
                             "(stacked [K,B,...] batches keep P('data'))")
        if config.tp_min_dim > 0:
            raise ValueError("spatial and tensor parallelism are exclusive (both consume "
                             "the 'model' mesh axis)")
    if config.tp_min_dim > 0 and no_model:
        raise ValueError("tensor parallelism (tp_min_dim > 0) needs a mesh with a 'model' "
                         f"axis > 1 (got {shape})")
    if config.pp_microbatches > 0:
        if no_model:
            raise ValueError("pipeline parallelism (pp_microbatches > 0) needs a mesh with a "
                             f"'model' axis > 1 (got {shape})")
        if config.tp_min_dim > 0 or config.spatial:
            raise ValueError("pp_microbatches is exclusive with tp_min_dim/spatial (all "
                             "consume the 'model' mesh axis)")


class _NoLog:
    """The metrics logger of a rank that is not rank 0."""

    def log(self, *args, **kw) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, workload: Workload, train_loader, val_loader, config: TrainConfig,
                 mesh=None):
        if config.grad_accum > 1 and config.steps_per_call > 1:
            raise ValueError("grad_accum > 1 and steps_per_call > 1 are exclusive "
                             "(both group loader batches into one call)")
        _mode_guards(config, mesh)
        self.wl = workload
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.cfg = config
        self.device = resolve_device(mesh.device if mesh is not None else config.device)
        # a group of one issues no collective: the single-process path
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.main = self.mesh is None or self.mesh.is_main
        self.model = workload.init_model(config.seed, self.device)
        # name -> the dim it is split along over the model group
        stage_names = {n: 0 for n in workload.stage_names(self.model)}
        self.tp_dims: Dict[str, int] = {}
        if self.mesh is not None and workload.cross_rank_bn:
            from automoe_tpu_torch.parallel.batchnorm import convert_batchnorm

            convert_batchnorm(self.model, self.mesh)
        if config.tp_min_dim > 0:
            from automoe_tpu_torch.parallel.tp import tp_shard_state

            self.tp_dims = tp_shard_state(self.model, self.mesh, min_dim=config.tp_min_dim)
            stage_names.update(self.tp_dims)
        if config.spatial:
            from automoe_tpu_torch.parallel.sp import spatial_model

            spatial_model(self.model, self.mesh)
        bpe = _optimizer_steps_per_epoch(len(train_loader), config.grad_accum)
        self.optimizer = make_optimizer(
            self.model.named_parameters(), learning_rate=config.learning_rate,
            weight_decay=config.weight_decay, total_steps=config.epochs * bpe,
            grad_clip=config.grad_clip, optimizer=config.optimizer,
            trainable_mask=workload.trainable_mask(self.model), schedule=config.schedule,
            steps_per_epoch=bpe, ema_decay=config.ema_decay)
        if self.mesh is not None:
            self.optimizer.shard(self.mesh, stage_names)
        self.train_step = make_train_step(workload.loss_fn)
        self.scan_step = (make_scan_train_step(workload.loss_fn)
                          if config.steps_per_call > 1 else None)
        self.accum_step = (make_grad_accum_train_step(workload.loss_fn)
                           if config.grad_accum > 1 else None)
        self.eval_step = make_eval_step(workload.loss_fn)
        self.indexed_step = (make_indexed_scan_train_step(workload.loss_fn,
                                                          config.steps_per_call)
                             if config.steps_per_call > 1 else None)
        self.layout = (None if self.mesh is None
                       else StageLayout(self.mesh, stage_names))
        self.ckpt = CheckpointManager(config.ckpt_root, workload.name, config.run_name,
                                      save_freq=config.save_freq,
                                      async_save=config.async_ckpt, keep=config.keep_epochs,
                                      layout=self.layout)
        self.logger = (MetricsLogger(f"{config.runs_root}/{workload.name}_{config.run_name}")
                       if self.main else _NoLog())
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
        self._pending: List[torch.Tensor] = []  # unread losses, oldest first
        self._loss_sum, self._loss_n = 0.0, 0

    def load_variables(self, path, prefer_ema: bool = False) -> None:
        """A checkpoint file's weights and BatchNorm statistics into the
        model (--init-from), a pipeline stage cut out of its stacks."""
        sd = state_dict_from_checkpoint(path, prefer_ema)
        load_state_into(self.model, sd if self.layout is None else self.layout.cut(sd),
                        str(path))

    def unsharded(self):
        """Tensor parallelism's slices whole for the block (a collective:
        every rank enters it), e.g. to graft weights into them by name."""
        from automoe_tpu_torch.parallel.tp import unsharded

        return unsharded(self.model, self.mesh, self.tp_dims)

    def whole_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict in the single-process layout (every rank
        calls it: under a model split, a collective)."""
        sd = self.model.state_dict()
        return sd if self.layout is None else self.layout.gather(sd)

    def reset_ema(self) -> None:
        """Start the EMA again at the parameters: after weights were
        grafted into fresh state (--init-from, --expert-ckpts)."""
        if self.optimizer.ema is not None:
            self.optimizer.ema.reset()

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in arrays.items():
            t = torch.as_tensor(v)
            # a resident loader's tensors are on the card already (one device)
            if t.device.type != self.device.type:
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    @staticmethod
    def _arrays(batch: Dict) -> Dict:
        return {k: v for k, v in batch.items() if not isinstance(v, list) and k != "_real_count"}

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        arrays = self._arrays(batch)
        if self.cfg.spatial:
            from automoe_tpu_torch.parallel.sp import check_spatial_batch

            check_spatial_batch(arrays, self.mesh)
        return self._to_device(arrays)

    def _device_group(self, group: List[Dict]) -> Dict[str, torch.Tensor]:
        """K host batches stacked [K, B, ...] into one buffer per key (over
        the keys all of them carry), one copy each."""
        arrays = [self._arrays(b) for b in group]
        keys = set(arrays[0]).intersection(*arrays[1:])
        return self._to_device({k: np.stack([np.asarray(a[k]) for a in arrays])
                                for k in sorted(keys)})

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
        save_every_steps boundary (a group crossing one writes it after
        the group)."""
        s = self.cfg.save_every_steps
        if s and consumed // s > self._step_save_marker:
            self._step_save_marker = consumed // s
            self.ckpt.save_step(self.model, self.optimizer, epoch, consumed)

    def _read_losses(self, limit: int) -> None:
        """Read the oldest unread losses until at most `limit` remain."""
        while len(self._pending) > limit:
            losses = self._pending.pop(0).float().reshape(-1).tolist()
            if self.cfg.debug_nans and not all(map(math.isfinite, losses)):
                raise FloatingPointError(f"non-finite train loss {losses} "
                                         f"(optimizer step {self.optimizer.count})")
            self._loss_sum += sum(losses)
            self._loss_n += len(losses)

    def _dispatch(self, step_fn, db: Dict[str, torch.Tensor], steps: int) -> None:
        """Launch `step_fn` (`steps` optimizer steps) without waiting for
        it, read what the in-flight bound asks for, log every log_every
        optimizer steps."""
        inflight = 0 if self.cfg.debug_nans else max(0, self.cfg.max_inflight)
        self.timer.start()
        metrics = step_fn(self.model, self.optimizer, db,
                          (self.cfg.seed + 1, self.optimizer.count))
        if self.mesh is not None:
            if self.wl.after_step is not None:
                self.wl.after_step(self.model)
            metrics = self.mesh.mean_metrics(metrics)
        self.timer.stop()
        self._pending.append(metrics["loss"])
        self._read_losses(inflight)
        if self.optimizer.count % self.cfg.log_every < steps:
            # steps per call return stacked metrics: log the last step's
            last = torch.stack([v.float().reshape(-1)[-1] for v in metrics.values()]).tolist()
            self.logger.log(self.optimizer.count,
                            {**dict(zip(metrics, last)), **self.timer.stats()},
                            prefix="train")

    def _mode(self):
        """(K loader batches per call, step function, optimizer steps per call)."""
        if self.scan_step is not None:
            return self.cfg.steps_per_call, self.scan_step, self.cfg.steps_per_call
        if self.accum_step is not None:
            return self.cfg.grad_accum, self.accum_step, 1
        return 1, self.train_step, 1

    def train_epoch(self, epoch: int) -> float:
        s = self.cfg.save_every_steps
        self._step_save_marker = (self.start_batch // s
                                  if s and epoch == self.start_epoch else 0)
        consumed0, skip_in_loop = self._set_epoch_with_skip(epoch)
        k, step_fn, steps = self._mode()
        # a loader that yields K-batch groups already stacked (and placed)
        pre_grouped = k > 1 and getattr(self.train_loader, "group_size", 1) == k
        indexed = pre_grouped and getattr(self.train_loader, "index_mode", False)
        if indexed:  # the loader yields {"__group_index__": g0}; the step slices
            loader = self.train_loader

            def step_fn(model, optimizer, marker, key):
                return self.indexed_step(model, optimizer, loader.epoch_batches,
                                         int(marker["__group_index__"]), key)
        self._loss_sum, self._loss_n = 0.0, 0
        t0 = time.time()
        anomaly = (torch.autograd.detect_anomaly(check_nan=True) if self.cfg.debug_nans
                   else contextlib.nullcontext())
        with anomaly:
            group: List[Dict] = []
            last_i = -1
            for i, batch in enumerate(self.train_loader):
                if i < skip_in_loop:
                    continue
                last_i = i
                if pre_grouped:
                    self._dispatch(step_fn, batch if indexed else self._device_batch(batch),
                                   steps)
                    self._maybe_save_step(epoch, consumed0 + (i + 1) * k)
                    continue
                group.append(batch)
                if len(group) < k:
                    continue
                db = self._device_batch(group[0]) if k == 1 else self._device_group(group)
                group = []
                self._dispatch(step_fn, db, steps)
                self._maybe_save_step(epoch, consumed0 + i + 1)
            # the tail of fewer than K batches: single steps
            tail0 = last_i - len(group) + 1
            for j, b in enumerate(group):
                self._dispatch(self.train_step, self._device_batch(b), 1)
                self._maybe_save_step(epoch, consumed0 + tail0 + j + 1)
            self._read_losses(0)
        n = self._loss_n
        avg = self._loss_sum / max(1, n)
        dt = time.time() - t0
        self.logger.log(self.optimizer.count, {"loss_epoch": avg, "epoch_seconds": dt,
                                               "steps_per_sec": n / max(dt, 1e-9)},
                        prefix="train")
        return avg

    def rebind_train_loader(self, loader) -> None:
        """Swap the training loader after construction (the
        --device-resident path builds its loader after the feature cache,
        which needs this Trainer's grafted or restored weights). Where the
        new loader's length differs (the resident loader trims N to a
        multiple of batch·group), the schedule set from the old length
        would decay over steps that never run: it is rebuilt for the
        new one. The optimizer's step count, moments and EMA stay."""
        self.train_loader = loader
        bpe = _optimizer_steps_per_epoch(len(loader), self.cfg.grad_accum)
        self.optimizer.steps_per_epoch = bpe
        self.optimizer.total_steps = max(self.cfg.epochs * bpe, 1)

    def validate(self, epoch: int, *, use_ema: bool = False, prefix: str = "val") -> float:
        """Validation epoch: loss and every scalar metric averaged over
        batches, logged under `prefix`. use_ema=True evaluates the EMA
        weights (with the model's BatchNorm statistics)."""
        weights = self.optimizer.ema.applied() if use_ema else contextlib.nullcontext()
        sums: Dict[str, float] = {}
        n = 0.0
        with weights:
            for batch in self.val_loader:
                real = batch.get("_real_count") if isinstance(batch, dict) else None
                db = self._device_batch(batch)
                w = 1.0
                if real is not None:
                    real = int(real)
                    w = real / max(1, next(iter(db.values())).shape[0])
                    # a pipeline's batch must still divide by its microbatches;
                    # every rank's tail holds the same count (the sampler
                    # equalises the shards)
                    if real % max(1, self.cfg.pp_microbatches) == 0:
                        db = {k: v[:real] for k, v in db.items()}
                metrics = self.eval_step(self.model, db)
                for k, v in metrics.items():
                    if getattr(v, "ndim", 1) == 0 or isinstance(v, (int, float)):
                        sums[k] = sums.get(k, 0.0) + float(v) * w
                n += w
        if self.mesh is not None:  # exact sums over the ranks, then one average
            keys = sorted(sums)
            total = self.mesh.sum_host([sums[k] for k in keys] + [n])
            sums, n = dict(zip(keys, total[:-1])), total[-1]
        denom = n if n > 0 else 1.0
        avg = {k: v / denom for k, v in sums.items()}
        self.logger.log(self.optimizer.count, avg, prefix=prefix)
        return avg.get("loss", float("inf"))

    def fit(self, config_dump: Optional[Dict] = None) -> Dict[str, float]:
        """Train, validate and checkpoint every epoch from start_epoch;
        config_dump (default: the TrainConfig) goes to config.json beside
        the checkpoints. Returns the best val loss (of the EMA weights when
        there is an EMA; a resumed run's included) and the train
        step-time statistics (per call; device time on CUDA)."""
        from automoe_tpu_torch.utils.profiling import trace

        config_dump = config_dump if config_dump is not None else dataclasses.asdict(self.cfg)
        best = self.ckpt.best_val
        for epoch in range(self.start_epoch, self.cfg.epochs):
            profiling = (trace(self.cfg.profile_dir)
                         if self.cfg.profile_dir and epoch == self.start_epoch and self.main
                         else contextlib.nullcontext())
            with profiling:
                train_loss = self.train_epoch(epoch)
            raw_val = val_loss = self.validate(epoch)
            ema_note = ""
            if self.optimizer.ema is not None:
                # the EMA is what an --ema-decay run deploys: it decides best
                val_loss = self.validate(epoch, use_ema=True, prefix="val_ema")
                ema_note = f" ema {val_loss:.4f}"
            is_best = self.ckpt.save_epoch(self.model, self.optimizer, epoch, val_loss,
                                           config_dump)
            best = min(best, val_loss)
            if self.main:
                print(f"[{self.wl.name}] epoch {epoch + 1}/{self.cfg.epochs} "
                      f"train {train_loss:.4f} val {raw_val:.4f}" + ema_note
                      + (" *best*" if is_best else ""), flush=True)
        self.ckpt.wait()  # queued writes land before callers read them
        stats = self.timer.stats()
        self.logger.log(self.optimizer.count, stats, prefix="train")
        self.logger.close()
        return {"best_val_loss": best, **stats}
