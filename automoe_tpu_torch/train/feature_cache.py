"""Frozen-expert feature cache for gating training (port of
automoe_tpu/train/feature_cache.py).

The gating step runs four frozen expert trunks on weights that never
change. Every gating extractor splits as (parameter-free pool/flatten) →
(trainable MLP head) (models/extractors.py), so the pooled expert outputs,
a few KB a sample, substitute exactly for running the trunks: one
eval-mode pass caches them, and every later train and val step feeds them
to the extractor heads (`AutoMoE.forward(..., cached_pooled=...)`). The
trainable parts (extractor MLPs, gating, context, policy) see the same
inputs and train the same.

The cache fixes the experts in eval mode: BatchNorm normalises by its
running statistics and stops moving. The reference's gating trainer runs
its experts in train mode (`requires_grad=False` stops neither), so cached
training is the standard frozen-BN variant, exactly the
`gating_workload(experts_eval=True)` step; validation, always eval mode,
is the same in both.
"""
from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

POOLED_KEY = "expert_pooled_{i}"


def pooled_keys(n_experts: int) -> List[str]:
    return [POOLED_KEY.format(i=i) for i in range(n_experts)]


def cache_fingerprint(state_dict: Dict[str, torch.Tensor], n: int, tag: str) -> str:
    """Content hash naming a pooled-feature cache: the expert entries of
    the model's state dict (`experts.*`: weights and BatchNorm statistics,
    the only model state the pooled features depend on), the dataset
    length and a tag naming the dataset (root and split). A re-graft, a
    dataset change or another tag gives another file."""
    h = hashlib.sha256()
    h.update(f"{tag}|{n}|".encode())
    for name in sorted(k for k in state_dict if k.startswith("experts.")):
        h.update(name.encode())
        h.update(np.ascontiguousarray(state_dict[name].detach().cpu().numpy()).tobytes())
    return h.hexdigest()[:32]


def _read(dataset, idxs: List[int], pool: ThreadPoolExecutor) -> Dict[str, np.ndarray]:
    reader = getattr(dataset, "read_batch", None)
    if reader is not None:
        return reader(idxs)
    samples = list(pool.map(dataset.__getitem__, idxs))
    return {k: np.stack([s[k] for s in samples]) for k in ("image", "lidar")
            if k in samples[0]}


def precompute_pooled_features(model, dataset, *, batch_size: int = 32,
                               verbose: bool = True, mesh=None) -> List[np.ndarray]:
    """One ordered eval-mode pass over `dataset` on the model's device →
    per-expert [N, d_i] float32 arrays of pooled extractor inputs. The
    tail batch is padded to `batch_size` with its first sample and sliced
    after, so every call sees one batch shape.

    mesh: a mesh of several ranks shares the pass over its data ranks:
    data rank d runs batches d, d + D, d + 2D, ... (the batches of the
    one-process pass, so the same rows), the model ranks of a data group
    run the same ones, and the results are all-gathered over the data
    group, so every rank ends with the whole cache."""
    from automoe_tpu_torch.models.automoe import automoe_pooled_features

    device = next(model.parameters()).device
    n = len(dataset)
    D = 1 if mesh is None else mesh.shape["data"]
    d = 0 if mesh is None else mesh.data_index
    n_batches = -(-n // batch_size)
    rounds = -(-n_batches // D)
    mine: List[List[torch.Tensor]] = []  # per round: the expert outputs of this rank's batch
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=8) as pool:  # decodes, for a dataset without read_batch
        for r in range(rounds):
            # a rank past the last batch repeats batch 0 so that every rank
            # gathers the same shapes; its rows are dropped below
            b = r * D + d
            start = (b if b < n_batches else 0) * batch_size
            real = min(batch_size, n - start)
            idxs = list(range(start, start + real)) + [start] * (batch_size - real)
            batch = {k: torch.as_tensor(v, dtype=torch.float32).to(device)
                     for k, v in _read(dataset, idxs, pool).items() if k in ("image", "lidar")}
            mine.append([o.float() for o in automoe_pooled_features(model, batch)])
    per_expert = [torch.stack([m[i] for m in mine]) for i in range(len(mine[0]))]
    if D > 1:  # [D, rounds, B, ...] → batches in pass order
        per_expert = [mesh.all_gather(t.contiguous(), "data").transpose(0, 1).flatten(0, 1)
                      for t in per_expert]
    feats = [t.flatten(0, 1)[:n].cpu().numpy() for t in per_expert]
    if verbose:
        dt = time.time() - t0
        mb = sum(f.nbytes for f in feats) / 1e6
        print(f"[feature-cache] {n} samples in {dt:.1f}s ({n / max(dt, 1e-9):.0f}/s), "
              f"{mb:.1f} MB pooled features" + (f", shared over {D} data ranks" if D > 1
                                                 else ""), flush=True)
    return feats


class PooledFeatureDataset:
    """A dataset with the cached pooled features added to each sample as
    `expert_pooled_{i}` (the cached gating loss consumes them). It has
    `read_batch` only when its base has one."""

    def __init__(self, base, feats: List[np.ndarray]):
        if any(len(f) != len(base) for f in feats):
            raise ValueError(f"feature cache rows {[len(f) for f in feats]} != "
                             f"dataset length {len(base)}")
        self.base = base
        self.feats = feats
        if hasattr(base, "read_batch"):
            self.read_batch = self._read_batch

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        sample = dict(self.base[idx])
        for i, f in enumerate(self.feats):
            sample[POOLED_KEY.format(i=i)] = f[idx]
        return sample

    def _read_batch(self, idxs) -> Dict[str, np.ndarray]:
        batch = dict(self.base.read_batch(idxs))
        ix = np.asarray(idxs)
        for i, f in enumerate(self.feats):
            batch[POOLED_KEY.format(i=i)] = f[ix]
        return batch

    def __getattr__(self, name):
        return getattr(self.base, name)


def attach_pooled_features(model, *loaders, batch_size: int = 32, verbose: bool = True,
                           cache_dir: Optional[str] = None,
                           cache_tags: Optional[List[str]] = None, mesh=None,
                           state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Swap each loader's dataset for its feature-cached wrapper, in place.
    Call after the expert checkpoints are grafted or restored: the cache
    must see the final frozen weights.

    cache_dir: keep each cache as `<cache_dir>/pooled_<fingerprint>.npz`,
    keyed by the experts' state, the dataset length and the loader's entry
    of `cache_tags` (name the dataset root and split); a re-run over the
    same experts and data then loads it instead of redoing the pass. The
    file is written to a temporary name and renamed, so a reader never
    sees half of one. mesh: a mesh of several ranks shares the pass over
    its data ranks (precompute_pooled_features) and only rank 0 writes the
    file. state_dict: the model's in the single-process layout, for the
    fingerprint (default model.state_dict(); a tensor-parallel model's
    holds slices)."""
    main = mesh is None or mesh.is_main
    for li, loader in enumerate(loaders):
        if loader is None:
            continue
        ds = loader.dataset
        path = None
        if cache_dir is not None:
            tag = cache_tags[li] if cache_tags else str(li)
            sd = model.state_dict() if state_dict is None else state_dict
            fp = cache_fingerprint(sd, len(ds), tag)
            path = os.path.join(cache_dir, f"pooled_{fp}.npz")
        found = path is not None and os.path.exists(path)
        if mesh is not None and mesh.size > 1:  # every rank takes the same branch
            found = min(mesh.sum_host([0.0 if found else 1.0])) == 0.0
        if found:
            with np.load(path) as z:
                feats = [z[f"feat_{i}"] for i in range(len(z.files))]
            if verbose:
                print(f"[feature-cache] loaded {path} ({len(feats[0])} samples)", flush=True)
        else:
            feats = precompute_pooled_features(model, ds, batch_size=batch_size,
                                               verbose=verbose, mesh=mesh)
            if path is not None and main:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp.npz"  # .npz: savez appends none
                np.savez(tmp, **{f"feat_{i}": f for i, f in enumerate(feats)})
                os.replace(tmp, path)
                if verbose:
                    print(f"[feature-cache] saved {path}", flush=True)
            if mesh is not None and path is not None:
                mesh.barrier()  # the file is whole before any rank looks again
        loader.dataset = PooledFeatureDataset(ds, feats)
