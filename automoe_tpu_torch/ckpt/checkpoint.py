"""Checkpoint save and restore (port of automoe_tpu/ckpt/checkpoint.py).

The JAX package's policy and layout, with torch files in place of orbax
directories: `<root>/<component>/<run_name>/{best,last,epoch_N,step}.pt`
plus `config.json`. `last` is written every epoch, `best` when the
validation loss improves, `epoch_N` every `save_freq` epochs (the newest
`keep` of them kept), and `step` mid-epoch, deleted once its epoch
completes. Each file holds one dict:

  model_state_dict  the model's state dict under the reference names, so
                    `ckpt.load_torch_state_dict` and
                    `InferenceEngine.from_torch_checkpoint` read it as is;
  ema_state_dict    with an EMA (--ema-decay), the average of every
                    parameter under the same names (the JAX package's
                    `ema_params`; BatchNorm statistics are not averaged);
  optimizer         `train.state.Optimizer.state_dict()` (step count and
                    AdamW moments of the trainable parameters);
  step, epoch, best_val_loss, and batch_index in a `step` checkpoint.

Restoring follows the JAX package where the checkpoint and the run
disagree on the EMA: a checkpoint's EMA that the run does not keep is
ignored; a run that keeps one from a checkpoint without it starts it at
the restored parameters. `load_variables(..., prefer_ema=True)` and
`state_dict_from_checkpoint(..., prefer_ema=True)` read the EMA in the
parameters' place and raise KeyError when the file has none (the JAX
package documents that, but returns the template's values).

A file is written to a temporary name in its directory, then renamed over
the target (`os.replace`), so a reader sees the old file or the new one,
never a torn one. With async_save the host snapshot is still taken in the
caller (no torn state); one background thread writes, in submission order.
`wait()` is the barrier: `Trainer.fit` calls it at the end and `restore`
calls it first.

Under a mesh of several ranks (`layout=`, a `StageLayout`), every rank
calls save and restore. A save gathers the pipeline stages' blocks (the
layout's names) over the model group back into their [L, ...] stacks, and
tensor parallelism's slices back into whole weights, in the weights, the
optimizer moments and the EMA, so the file has the single-process layout
whatever wrote it; rank 0 alone writes, between two barriers (the JAX
package's process-0 write). Every rank restores from the same file and
cuts its own stage back out of it.
"""
from __future__ import annotations

import json
import os
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

SUFFIX = ".pt"


def _host_copy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A snapshot on the host that later in-place updates cannot touch."""
    return {k: v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v
            for k, v in state.items()}


def _atomic_save(obj: Any, path: Path) -> None:
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(obj, fh)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def load_checkpoint(path) -> Dict[str, Any]:
    """A checkpoint file as written by CheckpointManager (tensors and
    Python scalars only, read with weights_only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_into(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                    source: str) -> None:
    """Load `state_dict` into `module`. Every key of the module must be in
    the checkpoint: a missing key raises instead of leaving that tensor at
    its initial value (the JAX package only warns by default,
    ckpt/checkpoint.py:256). Checkpoint keys the module lacks are skipped,
    as the JAX package's partial restore skips them."""
    missing = sorted(set(module.state_dict()) - set(state_dict))
    if missing:
        raise KeyError(f"{source}: {len(missing)} keys of the model are missing from the "
                       f"checkpoint and would keep their initial values: {missing[:5]}"
                       + (" ..." if len(missing) > 5 else ""))
    module.load_state_dict({k: state_dict[k] for k in module.state_dict()}, strict=True)


def state_dict_from_checkpoint(path, prefer_ema: bool = False) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint file; prefer_ema=True puts the
    EMA of the parameters in their place (KeyError without one)."""
    payload = load_checkpoint(path)
    sd = dict(payload["model_state_dict"])
    if prefer_ema:
        if "ema_state_dict" not in payload:
            raise KeyError(f"{path}: no EMA weights in this checkpoint (written by a run "
                           "without --ema-decay)")
        sd.update(payload["ema_state_dict"])
    return sd


def load_variables(path, module: nn.Module, *, prefer_ema: bool = False) -> None:
    """Load only the model weights and BatchNorm statistics of a checkpoint
    into `module` (evaluation, --init-from), with load_state_into's guard;
    prefer_ema=True loads the EMA weights."""
    load_state_into(module, state_dict_from_checkpoint(path, prefer_ema), str(path))


class StageLayout:
    """How a mesh splits named tensors over its model group: `dims` maps
    each split tensor to the dim it is cut along (dim 0 for a pipeline
    stage's blocks of an [L, ...] stack, parallel/pp.py; each weight's
    output dim under tensor parallelism, parallel/tp.py); the rest are
    whole."""

    def __init__(self, mesh, dims: Mapping[str, int]):
        self.mesh = mesh
        self.dims: Dict[str, int] = dict(dims)

    def gather(self, named: Mapping[str, Any]) -> Dict[str, Any]:
        """The whole tensors back from the model group (a collective)."""
        from automoe_tpu_torch.parallel.mesh import MODEL_AXIS

        if not self.dims or self.mesh.shape[MODEL_AXIS] == 1:
            return dict(named)
        return {k: (torch.cat(self.mesh.all_gather(v.contiguous(), "model").unbind(0),
                              dim=self.dims[k])
                    if k in self.dims else v) for k, v in named.items()}

    def cut(self, named: Mapping[str, Any]) -> Dict[str, Any]:
        """This rank's slice of each whole tensor (contiguous: slice m of
        M along its dim)."""
        from automoe_tpu_torch.parallel.mesh import MODEL_AXIS

        if not self.dims:
            return dict(named)
        M, m = self.mesh.shape[MODEL_AXIS], self.mesh.model_index
        out = dict(named)
        for k, d in self.dims.items():
            if k in out:
                v = torch.as_tensor(out[k])
                if v.shape[d] % M:
                    raise ValueError(f"{k}: dim {d} of {tuple(v.shape)} must divide by the "
                                     f"mesh 'model' axis ({M})")
                out[k] = v.chunk(M, dim=d)[m]
        return out


class CheckpointManager:
    def __init__(self, root: str, component: str, run_name: str, *, save_freq: int = 0,
                 async_save: bool = False, keep: int = 0, layout: Optional[StageLayout] = None):
        """keep: retain only the newest `keep` periodic epoch_N files
        (0 keeps all); best, last and step are never removed. layout: the
        mesh of a run of several ranks and its stage-local names."""
        self.layout = layout
        self.writer = layout is None or layout.mesh.is_main
        self.dir = Path(root) / component / run_name  # made at the first write
        self.save_freq = save_freq
        self.keep = keep
        self.best_val = float("inf")
        self.last_restore_loaded = False  # set by restore()
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: List[Future] = []

    def path(self, which: str) -> Path:
        return self.dir / f"{which}{SUFFIX}"

    def _barrier(self) -> None:
        if self.layout is not None:
            self.layout.mesh.barrier()

    def _run(self, fn: Callable[[], None]) -> None:
        """Run a file operation now, or queue it behind the earlier ones
        (on the writing rank only)."""
        if not self.writer:
            return
        if self._pool is None:
            fn()
        else:
            self._pending.append(self._pool.submit(fn))

    def wait(self) -> None:
        """Block until every queued write has landed; re-raise the first
        write that failed."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
        self._barrier()

    # -- save ---------------------------------------------------------------

    def _whole(self, named: Mapping[str, Any]) -> Dict[str, Any]:
        return dict(named) if self.layout is None else self.layout.gather(named)

    def _payload(self, model: nn.Module, optimizer, epoch: int) -> Dict[str, Any]:
        """The file's dict (every rank: the stage gather is a collective)."""
        self._barrier()
        opt = optimizer.state_dict()
        mus = self._whole({n: mn[0] for n, mn in opt["state"].items()})
        nus = self._whole({n: mn[1] for n, mn in opt["state"].items()})
        state = {n: (mus[n], nus[n]) for n in opt["state"]}
        payload = {
            "model_state_dict": _host_copy(self._whole(model.state_dict())),
            "optimizer": {"count": opt["count"], "state": {
                n: tuple(t.detach().to("cpu", copy=True) for t in mn)
                for n, mn in state.items()}},
            "step": int(opt["count"]),
            "epoch": int(epoch),
            "best_val_loss": float(self.best_val),
        }
        if optimizer.ema is not None:
            payload["ema_state_dict"] = _host_copy(self._whole(optimizer.ema.state_dict()))
        return payload

    def _write(self, which: str, payload: Dict[str, Any], config: Optional[Dict]) -> None:
        path = self.path(which)

        def write():
            self.dir.mkdir(parents=True, exist_ok=True)
            _atomic_save(payload, path)
            if config is not None:
                (self.dir / "config.json").write_text(json.dumps(config, indent=2))

        self._run(write)

    def save_epoch(self, model: nn.Module, optimizer, epoch: int, val_loss: float,
                   config: Optional[Dict] = None) -> bool:
        """Write `last` (and `epoch_N` every save_freq epochs), and `best`
        when val_loss improves; drop the epoch's `step` file. Returns
        whether this epoch is the best so far."""
        is_best = val_loss < self.best_val
        if is_best:
            self.best_val = float(val_loss)
        payload = self._payload(model, optimizer, epoch)
        self._write("last", payload, config)
        if is_best:
            self._write("best", payload, None)
        if self.save_freq and (epoch + 1) % self.save_freq == 0:
            self._write(f"epoch_{epoch + 1}", payload, None)
            if self.keep > 0:
                self._run(self._collect_epochs)
        # the epoch is complete: a mid-epoch `step` file is stale now
        # (restoring it would retrain this epoch's tail and roll back
        # best_val); restore(which="step") falls back to `last`
        self._run(lambda: self.path("step").unlink(missing_ok=True))
        if self._pool is None:
            self._barrier()
        return is_best

    def _collect_epochs(self) -> None:
        olds = sorted(self.dir.glob(f"epoch_*{SUFFIX}"),
                      key=lambda p: int(p.name[len("epoch_"):-len(SUFFIX)]))
        for p in olds[:-self.keep]:
            p.unlink()

    def save_step(self, model: nn.Module, optimizer, epoch: int, batch_index: int,
                  config: Optional[Dict] = None) -> None:
        """Mid-epoch `step` checkpoint: the epoch payload plus the number
        of batches of `epoch` already consumed, so a resume fast-forwards
        the loader's (seeded) shuffle."""
        payload = self._payload(model, optimizer, epoch)
        payload["batch_index"] = int(batch_index)
        self._write("step", payload, config)
        if self._pool is None:
            self._barrier()

    # -- restore ------------------------------------------------------------

    def restore(self, model: nn.Module, optimizer, which: str = "best",
                mode: str = "full") -> Tuple[int, int]:
        """Load checkpoint `which` (best | last | epoch_N | step) into the
        model ('model': weights and BatchNorm statistics) and, with
        mode='full', the optimizer; in both modes the optimizer's EMA, if
        it keeps one (from the file's, else at the restored parameters).
        Returns (epoch, batch_index), the
        batch index being 0 except for a `step` checkpoint. A missing
        `step` falls back to `last` and returns (its epoch + 1, 0); with
        neither, nothing is loaded, last_restore_loaded is False and
        (0, 0) is returned."""
        if mode not in ("model", "full"):
            raise ValueError(f"unknown restore mode {mode}")
        self.wait()  # a queued write may be `which`
        path = self.path(which)
        if which == "step" and not path.exists():
            if not self.path("last").exists():
                # nothing landed before the crash: a relaunch with
                # --resume-from step starts fresh instead of failing
                self.last_restore_loaded = False
                return 0, 0
            epoch, _ = self.restore(model, optimizer, which="last", mode=mode)
            return epoch + 1, 0
        payload = load_checkpoint(path)
        cut = (lambda d: dict(d)) if self.layout is None else self.layout.cut
        load_state_into(model, cut(payload["model_state_dict"]), str(path))
        if mode == "full":
            opt = payload["optimizer"]
            mus = cut({n: mn[0] for n, mn in opt["state"].items()})
            nus = cut({n: mn[1] for n, mn in opt["state"].items()})
            optimizer.load_state_dict({"count": opt["count"],
                                       "state": {n: (mus[n], nus[n]) for n in opt["state"]}})
        if optimizer.ema is not None:
            if "ema_state_dict" in payload:
                optimizer.ema.load_state_dict(cut(payload["ema_state_dict"]))
            else:
                optimizer.ema.reset()
        self.best_val = float(payload["best_val_loss"])
        self.last_restore_loaded = True
        return int(payload["epoch"]), int(payload.get("batch_index", 0))
