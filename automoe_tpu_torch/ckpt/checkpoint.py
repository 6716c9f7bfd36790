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
  optimizer         `train.state.Optimizer.state_dict()` (step count and
                    AdamW moments of the trainable parameters);
  step, epoch, best_val_loss, and batch_index in a `step` checkpoint.

A file is written to a temporary name in its directory, then renamed over
the target (`os.replace`), so a reader sees the old file or the new one,
never a torn one. With async_save the host snapshot is still taken in the
caller (no torn state); one background thread writes, in submission order.
`wait()` is the barrier: `Trainer.fit` calls it at the end and `restore`
calls it first.
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


def load_variables(path, module: nn.Module) -> None:
    """Load only the model weights and BatchNorm statistics of a checkpoint
    into `module` (evaluation, --init-from), with load_state_into's guard."""
    load_state_into(module, load_checkpoint(path)["model_state_dict"], str(path))


class CheckpointManager:
    def __init__(self, root: str, component: str, run_name: str, *, save_freq: int = 0,
                 async_save: bool = False, keep: int = 0):
        """keep: retain only the newest `keep` periodic epoch_N files
        (0 keeps all); best, last and step are never removed."""
        self.dir = Path(root) / component / run_name  # made at the first write
        self.save_freq = save_freq
        self.keep = keep
        self.best_val = float("inf")
        self.last_restore_loaded = False  # set by restore()
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: List[Future] = []

    def path(self, which: str) -> Path:
        return self.dir / f"{which}{SUFFIX}"

    def _run(self, fn: Callable[[], None]) -> None:
        """Run a file operation now, or queue it behind the earlier ones."""
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

    # -- save ---------------------------------------------------------------

    def _payload(self, model: nn.Module, optimizer, epoch: int) -> Dict[str, Any]:
        opt = optimizer.state_dict()
        return {
            "model_state_dict": _host_copy(model.state_dict()),
            "optimizer": {"count": opt["count"], "state": {
                n: tuple(t.detach().to("cpu", copy=True) for t in mn)
                for n, mn in opt["state"].items()}},
            "step": int(opt["count"]),
            "epoch": int(epoch),
            "best_val_loss": float(self.best_val),
        }

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

    # -- restore ------------------------------------------------------------

    def restore(self, model: nn.Module, optimizer, which: str = "best",
                mode: str = "full") -> Tuple[int, int]:
        """Load checkpoint `which` (best | last | epoch_N | step) into the
        model ('model': weights and BatchNorm statistics) and, with
        mode='full', the optimizer. Returns (epoch, batch_index), the
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
        load_state_into(model, payload["model_state_dict"], str(path))
        if mode == "full":
            optimizer.load_state_dict(payload["optimizer"])
        self.best_val = float(payload["best_val_loss"])
        self.last_restore_loaded = True
        return int(payload["epoch"]), int(payload.get("batch_index", 0))
