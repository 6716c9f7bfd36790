"""Device-resident epoch loader for one device (port of
automoe_tpu/data/device_resident.py without the mesh, multi-host staging
and `index_mode`, which come with the `parallel/` slice).

It stages an epoch's working set on the card once, reshuffles it
sample by sample on the card each epoch, and yields batches (or stacked
[K,B,...] groups of K batches) that are already there: the train loop
then makes no host→device copy a step. Its use is the cached gating
trainer (`--cache-expert-features --device-resident`): pooled features,
controls, waypoints and frames (the policy head trains its own backbone
through the frames, so they are staged too, at S·S·3·4 B a sample).

Protocol, as the Trainer reads it: `__len__` is BATCHES an epoch,
`set_epoch(epoch, skip_batches=0)`, iteration, and `group_size`: with
`group_size == K == TrainConfig.steps_per_call` the Trainer hands each
yielded [K,B,...] group straight to its K-step call.

Order, as the JAX loader's for the same seed: epoch e permutes the flat
samples with `np.random.default_rng((seed, e)).permutation(N)` (applied on
the card by `index_select`), lays them out as [G,K,B,...] groups, then
draws the group order from the same generator.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from automoe_tpu_torch.utils import resolve_device


class DeviceEpochLoader:
    """One epoch of per-sample arrays, resident on `device`, reshuffled
    there each epoch.

    arrays: name → [N, ...] per-sample data. batch_size B. group_size K
    batches a yielded group (match TrainConfig.steps_per_call; 1 yields
    plain [B,...] batches). steps_per_epoch: batches an epoch, N // B by
    default; a larger count cycles the pool with fresh group orders.
    shared: name → [B, ...] per-batch constants, staged once (tiled to
    [K,B,...] when K > 1) and yielded with every group."""

    def __init__(self, arrays: Dict[str, np.ndarray], *, batch_size: int, group_size: int = 1,
                 shared: Optional[Dict[str, np.ndarray]] = None, seed: int = 0,
                 steps_per_epoch: Optional[int] = None, device=None):
        if not arrays:
            raise ValueError("arrays must be non-empty")
        n = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"array '{k}' has {len(v)} samples, expected {n}")
        B, K = batch_size, max(1, group_size)
        if n % (B * K):
            raise ValueError(f"N={n} must divide by batch_size*group_size={B * K} "
                             "(trim the arrays — static shapes, no tail)")
        self.batch_size = B
        self.group_size = K
        self.seed = seed
        self.device = resolve_device(device)
        self._n = n
        self._groups_nat = n // (B * K)
        spe = steps_per_epoch if steps_per_epoch is not None else n // B
        if spe % K:
            raise ValueError(f"steps_per_epoch={spe} must divide by group_size={K}")
        self._steps_per_epoch = spe
        self._groups = spe // K
        # the flat epoch, staged once: the run's only bulk host→device copy
        self._flat = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                      for k, v in arrays.items()}
        self._shared: Dict[str, torch.Tensor] = {}
        for k, v in (shared or {}).items():
            v = np.asarray(v)
            if len(v) != B:
                raise ValueError(f"shared '{k}' must be a [B={B}, ...] batch, got {v.shape}")
            t = torch.as_tensor(v).to(self.device)
            self._shared[k] = t.expand(K, *t.shape) if K > 1 else t
        self._epoch: Optional[Dict[str, torch.Tensor]] = None  # name → [G,(K,)B,...]
        self._order = np.arange(self._groups)
        self._skip_groups = 0
        self.set_epoch(0)

    @classmethod
    def from_dataset(cls, dataset, *, batch_size: int, group_size: int = 1, seed: int = 0,
                     read_chunk: int = 256, verbose: bool = True,
                     device=None) -> "DeviceEpochLoader":
        """Materialise a map-style dataset on the card. Reads every sample
        once on the host (through `read_batch` when the dataset has it, in
        chunks of `read_chunk`), drops `_real_count` and non-array fields,
        and trims N to a multiple of batch_size·group_size (the host
        loader's drop-last rule, extended to the group). Every model input
        is staged, frames included: the cached gating step's policy
        backbone trains through them."""
        n_total = len(dataset)
        B, K = batch_size, max(1, group_size)
        n = (n_total // (B * K)) * (B * K)
        if n == 0:
            raise ValueError(f"dataset has {n_total} samples < one "
                             f"batch_size*group_size={B * K} group")
        reader = getattr(dataset, "read_batch", None)
        chunks = []
        for lo in range(0, n, read_chunk):
            idxs = list(range(lo, min(lo + read_chunk, n)))
            if reader is not None:
                c = {k: v for k, v in reader(idxs).items() if k != "_real_count"}
            else:
                rows = [dataset[i] for i in idxs]
                keys = set(rows[0]).intersection(*rows[1:])
                c = {k: np.stack([np.asarray(r[k]) for r in rows])
                     for k in sorted(keys - {"_real_count"})
                     if not isinstance(rows[0][k], (list, str, dict))}
            chunks.append(c)
        keys = set(chunks[0]).intersection(*chunks[1:])
        arrays = {k: np.concatenate([c[k] for c in chunks]) for k in sorted(keys)
                  if np.asarray(chunks[0][k]).dtype != object}
        if verbose:
            mib = sum(v.nbytes for v in arrays.values()) / 2**20
            print(f"[device-resident] staged {n}/{n_total} samples, {len(arrays)} fields, "
                  f"{mib:.1f} MiB", flush=True)
        return cls(arrays, batch_size=B, group_size=K, seed=seed, device=device)

    def __len__(self) -> int:  # BATCHES an epoch (the schedule's unit)
        return self._steps_per_epoch

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Reshuffle for `epoch` on the card, deterministic in (seed,
        epoch); skip_batches resumes mid-epoch (a multiple of group_size)."""
        if skip_batches % self.group_size:
            raise ValueError(f"skip_batches={skip_batches} must align to "
                             f"group_size={self.group_size}")
        rng = np.random.default_rng((self.seed, epoch))
        perm = torch.as_tensor(rng.permutation(self._n)).to(self.device)
        B, K = self.batch_size, self.group_size
        lead = (self._groups_nat, K, B) if K > 1 else (self._n // B, B)
        # drop the last epoch's copy before gathering the next: with frames
        # resident it is pool-sized
        self._epoch = None
        self._epoch = {k: v.index_select(0, perm).reshape(*lead, *v.shape[1:])
                       for k, v in self._flat.items()}
        reps = -(-self._groups // self._groups_nat)
        self._order = np.concatenate([rng.permutation(self._groups_nat)
                                      for _ in range(reps)])[:self._groups]
        self._skip_groups = skip_batches // self.group_size

    def __iter__(self):
        skip, self._skip_groups = self._skip_groups, 0  # one-shot (resume)
        for g in self._order[skip:]:
            out = {k: v[int(g)] for k, v in self._epoch.items()}
            out.update(self._shared)
            yield out
