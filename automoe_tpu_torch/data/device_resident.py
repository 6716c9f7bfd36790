"""Device-resident epoch loader (port of automoe_tpu/data/device_resident.py).

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
yielded [K,B,...] group straight to its K-step call. With
`index_mode=True` the loader yields `{"__group_index__": g·K}` instead, a
base batch index into `epoch_batches` (the epoch's flat [S, B, ...]
layout), and the Trainer's indexed K-step call (train/step.py::
make_indexed_scan_train_step) takes batches g·K .. g·K + K − 1 from it.

Order, as the JAX loader's for the same seed: epoch e permutes the flat
samples with `np.random.default_rng((seed, e)).permutation(N)` (applied on
the card by `index_select`), lays them out as [G,K,B,...] groups, then
draws the group order from the same generator.

Several ranks (`mesh=` with a 'data' axis D > 1): as the JAX package's
multi-host loader, data rank d stages only its shard of the dataset
(`from_dataset(indices=range(d, N, D))`, every rank the same count, the
minimum over the world) and `batch_size` rows of each global batch. The
global flat epoch is the ranks' shards in rank order (N = D·n samples,
global batches of D·B rows), permuted each epoch by the same generator on
every rank, and rank d trains on rows [d·B, (d+1)·B) of every global
batch. A rank holds only its shard, so each epoch's permutation is
followed by an exchange: each rank sends each peer exactly the rows of its
shard that the peer's batches need (`Mesh.all_to_all` over the data group,
one field at a time, through host memory under gloo on a card). No rank
holds a whole-dataset copy of a field: besides its shard, a field's
exchange holds the rows it sends, receives and puts in order, a shard's
count each. The model ranks of one data group
stage the same shard.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from automoe_tpu_torch.utils import resolve_device


class DeviceEpochLoader:
    """One epoch of per-sample arrays, resident on `device`, reshuffled
    there each epoch.

    arrays: name → [n, ...] per-sample data (this data rank's shard under
    a mesh). batch_size B (rows a rank). group_size K batches a yielded
    group (match TrainConfig.steps_per_call; 1 yields plain [B,...]
    batches). steps_per_epoch: batches an epoch, N // (B·D) by default; a
    larger count cycles the pool with fresh group orders. shared: name →
    [B, ...] per-batch constants, staged once (tiled to [K,B,...] when
    K > 1) and yielded with every group. index_mode: yield base indices
    (module docstring)."""

    def __init__(self, arrays: Dict[str, np.ndarray], *, batch_size: int, group_size: int = 1,
                 shared: Optional[Dict[str, np.ndarray]] = None, seed: int = 0,
                 steps_per_epoch: Optional[int] = None, device=None, mesh=None,
                 index_mode: bool = False):
        if not arrays:
            raise ValueError("arrays must be non-empty")
        if index_mode and shared:
            raise ValueError("index_mode yields base indices into the flat epoch — per-batch "
                             "`shared` constants can't ride along; merge them into `arrays` or "
                             "disable index_mode")
        self.index_mode = bool(index_mode)
        n_local = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if len(v) != n_local:
                raise ValueError(f"array '{k}' has {len(v)} samples, expected {n_local}")
        self.mesh = mesh if mesh is not None and mesh.shape["data"] > 1 else None
        D = 1 if self.mesh is None else self.mesh.shape["data"]
        self._rank = 0 if self.mesh is None else self.mesh.data_index
        self._D = D
        B_local, K = batch_size, max(1, group_size)
        n, B = n_local * D, B_local * D
        if n % (B * K):
            raise ValueError(f"N={n} must divide by batch_size*group_size={B * K} "
                             "(trim the arrays — static shapes, no tail)")
        self.batch_size = B_local  # this rank's rows (the Trainer's view)
        self.group_size = K
        self.seed = seed
        self.device = resolve_device(device if self.mesh is None else self.mesh.device)
        self._n, self._n_local, self._B = n, n_local, B
        self._groups_nat = n // (B * K)
        spe = steps_per_epoch if steps_per_epoch is not None else n // B
        if spe % K:
            raise ValueError(f"steps_per_epoch={spe} must divide by group_size={K}")
        self._steps_per_epoch = spe
        self._groups = spe // K
        # this rank's shard of the flat epoch, staged once: the run's only
        # bulk host→device copy
        self._flat = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                      for k, v in arrays.items()}
        self._shared: Dict[str, torch.Tensor] = {}
        for k, v in (shared or {}).items():
            v = np.asarray(v)
            if len(v) != B_local:
                raise ValueError(f"shared '{k}' must be a [B={B_local}, ...] batch, got "
                                 f"{v.shape}")
            t = torch.as_tensor(v).to(self.device)
            self._shared[k] = t.expand(K, *t.shape) if K > 1 else t
        self._epoch: Optional[Dict[str, torch.Tensor]] = None  # name → [G,(K,)B,...]
        self._order = np.arange(self._groups)
        self._skip_groups = 0
        self.set_epoch(0)

    @classmethod
    def from_dataset(cls, dataset, *, batch_size: int, group_size: int = 1, seed: int = 0,
                     read_chunk: int = 256, verbose: bool = True, device=None, mesh=None,
                     indices: Optional[Sequence[int]] = None,
                     index_mode: bool = False) -> "DeviceEpochLoader":
        """Materialise a map-style dataset on the card. Reads every sample
        once on the host (through `read_batch` when the dataset has it, in
        chunks of `read_chunk`), drops `_real_count` and non-array fields,
        and trims N to a multiple of batch_size·group_size (the host
        loader's drop-last rule, extended to the group). Every model input
        is staged, frames included: the cached gating step's policy
        backbone trains through them. `indices` restricts the read to a
        subset (a data rank's shard, module docstring); under a mesh every
        rank stages the minimum count over the world."""
        idx_all = list(indices) if indices is not None else list(range(len(dataset)))
        n_total = len(idx_all)
        B, K = batch_size, max(1, group_size)
        if mesh is not None and mesh.size > 1:
            counts = mesh.all_gather(torch.tensor(n_total, device=mesh.device))
            n_total = int(counts.min())
        n = (n_total // (B * K)) * (B * K)
        if n == 0:
            raise ValueError(f"dataset has {n_total} samples < one "
                             f"batch_size*group_size={B * K} group")
        reader = getattr(dataset, "read_batch", None)
        chunks = []
        for lo in range(0, n, read_chunk):
            idxs = idx_all[lo:min(lo + read_chunk, n)]
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
        return cls(arrays, batch_size=B, group_size=K, seed=seed, device=device, mesh=mesh,
                   index_mode=index_mode)

    def __len__(self) -> int:  # BATCHES an epoch (the schedule's unit)
        return self._steps_per_epoch

    def _mine(self, perm: np.ndarray, d: int) -> np.ndarray:
        """Data rank d's rows of every global batch of the permuted flat
        epoch `perm`: [S, B] → [S, B_local], flattened."""
        B, Bl = self._B, self.batch_size
        return perm.reshape(-1, B)[:, d * Bl:(d + 1) * Bl].reshape(-1)

    def _rows(self, perm: np.ndarray) -> Dict[str, torch.Tensor]:
        """This rank's rows of the permuted flat epoch `perm` (global sample
        indices), in order: from its shard alone, or from the data
        group's. Every rank knows every rank's rows (the permutation is
        the same on all), so each sends each peer exactly the rows of its
        shard that the peer needs, one all-to-all a field."""
        mine = self._mine(perm, self._rank)
        if self.mesh is None:
            idx = torch.as_tensor(mine).to(self.device)
            return {k: v.index_select(0, idx) for k, v in self._flat.items()}
        n, me = self._n_local, self._rank  # rank r holds global rows [r·n, (r+1)·n)
        send = []
        for d in range(self._D):
            want = self._mine(perm, d)
            send.append(want[want // n == me] - me * n)  # in d's order
        owner = mine // n
        recv_counts = [int((owner == r).sum()) for r in range(self._D)]
        # the received rows come by owner, each owner's in this rank's order
        by_owner = np.argsort(owner, kind="stable")
        back = torch.as_tensor(np.argsort(by_owner)).to(self.device)
        sidx = torch.as_tensor(np.concatenate(send)).to(self.device)
        out = {}
        for k, v in self._flat.items():
            got = self.mesh.all_to_all(v.index_select(0, sidx), [len(x) for x in send],
                                       recv_counts, "data")
            out[k] = got.index_select(0, back)
        return out

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Reshuffle for `epoch` on the card, deterministic in (seed,
        epoch); skip_batches resumes mid-epoch (a multiple of group_size)."""
        if skip_batches % self.group_size:
            raise ValueError(f"skip_batches={skip_batches} must align to "
                             f"group_size={self.group_size}")
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(self._n)
        B, K, Bl = self._B, self.group_size, self.batch_size
        grouped = K > 1 and not self.index_mode
        lead = (self._groups_nat, K, Bl) if grouped else (self._n // B, Bl)
        # drop the last epoch's copy before gathering the next: with frames
        # resident it is pool-sized
        self._epoch = None
        self._epoch = {k: v.reshape(*lead, *v.shape[1:]) for k, v in self._rows(perm).items()}
        reps = -(-self._groups // self._groups_nat)
        self._order = np.concatenate([rng.permutation(self._groups_nat)
                                      for _ in range(reps)])[:self._groups]
        self._skip_groups = skip_batches // self.group_size

    @property
    def epoch_batches(self) -> Dict[str, torch.Tensor]:
        """index_mode: the epoch's flat [S, B, ...] batches on the card
        (set_epoch makes them anew)."""
        return self._epoch

    def __iter__(self):
        skip, self._skip_groups = self._skip_groups, 0  # one-shot (resume)
        for g in self._order[skip:]:
            if self.index_mode:
                yield {"__group_index__": np.int32(int(g) * self.group_size)}
                continue
            out = {k: v[int(g)] for k, v in self._epoch.items()}
            out.update(self._shared)
            yield out
