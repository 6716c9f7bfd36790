"""Host-side data loader: sharded shuffled sampling + threaded decode +
prefetch (port of automoe_tpu/data/loader.py, without the mesh transfer
hook and custom collates: a rank copies its own batch to its card).

ShardedSampler gives the JAX package's per-epoch order for a given seed
(numpy's default_rng(seed + epoch)), equalised across `num_shards` shards
and interleaved as the JAX sampler does, so the port's Trainer sees the
same batch sequence, and rank `shard_index` of a data-parallel run reads
what JAX's process `shard_index` reads; DataLoader decodes samples on a
thread pool and keeps
PREFETCH collated numpy batches ready. A dataset with `read_batch`
(the packed caches, data/packed.py and data/native_packed.py) is
gathered a whole batch at a time instead: no per-sample map, no collate.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

import numpy as np

from automoe_tpu_torch.data.collate import stack_batch

PREFETCH = 2  # collated batches kept ready


class ShardedSampler:
    """Deterministic shuffled index stream, sharded across data ranks."""

    def __init__(self, num_samples: int, *, shuffle: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0, drop_last: bool = True,
                 batch_size: int = 1):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.batch_size = batch_size
        self.epoch = 0
        self.skip_batches = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """skip_batches: start the epoch's batch stream that many batches
        in. A mid-epoch resume skips at the index level, so the batches
        already consumed are never decoded."""
        self.epoch = epoch
        self.skip_batches = skip_batches

    def _per_shard(self) -> int:
        if self.drop_last:
            return self.num_samples // self.num_shards
        return -(-self.num_samples // self.num_shards)

    def __iter__(self) -> Iterator[tuple[List[int], int]]:
        """Yields (indices, real count): the last batch of a non-drop_last
        epoch is repeat-padded to the batch size and carries its real count."""
        idx = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        # equalise the shards first (torch DistributedSampler semantics):
        # truncate, or wrap-pad, so every shard runs the same number of
        # collective steps an epoch; then interleave
        total = self._per_shard() * self.num_shards
        idx = idx[:total] if total <= len(idx) else np.resize(idx, total)
        idx = idx[self.shard_index::self.num_shards]
        n_full = len(idx) // self.batch_size
        for b in range(min(self.skip_batches, n_full), n_full):
            yield idx[b * self.batch_size: (b + 1) * self.batch_size].tolist(), self.batch_size
        rem = idx[n_full * self.batch_size:]
        if len(rem) and not self.drop_last and self.skip_batches <= n_full:
            yield np.resize(rem, self.batch_size).tolist(), len(rem)

    def __len__(self) -> int:
        n = self._per_shard()
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


class DataLoader:
    """Iterable over collated numpy batches; a padded tail batch carries
    `_real_count`."""

    def __init__(self, dataset, *, batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = True, num_shards: int = 1,
                 shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.sampler = ShardedSampler(len(dataset), shuffle=shuffle, seed=seed,
                                      num_shards=num_shards, shard_index=shard_index,
                                      drop_last=drop_last, batch_size=batch_size)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        self.sampler.set_epoch(epoch, skip_batches)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self):
        batches = iter(self.sampler)
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            # a bounded put that notices the consumer leaving early
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        # read at iteration time: attach_pooled_features swaps the dataset
        read_batch = getattr(self.dataset, "read_batch", None)

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx, real in batches:
                        if stop.is_set():
                            return
                        if read_batch is not None:
                            batch = read_batch(batch_idx)
                        else:
                            batch = stack_batch(list(pool.map(self.dataset.__getitem__,
                                                              batch_idx)))
                        if real != len(batch_idx):
                            batch = dict(batch)
                            batch["_real_count"] = real
                        if not put(batch):
                            return
            except BaseException as e:  # surface in the consumer, not on stderr
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise RuntimeError("DataLoader worker failed (the epoch would otherwise "
                                       "be silently truncated)") from item
                yield item
        finally:
            stop.set()
            try:
                while True:  # unblock a producer stuck on a full queue
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5)
