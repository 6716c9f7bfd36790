"""Host-side data loader: shuffled sampling + threaded decode + prefetch
(port of automoe_tpu/data/loader.py for one host: without the packed-cache
batch read, the mesh transfer hook, custom collates and the sampler's
multi-host sharding, which come with the multi-host slice).

ShardedSampler gives the JAX package's per-epoch order for a given seed
(numpy's default_rng(seed + epoch)), so the port's Trainer sees the same
batch sequence; DataLoader decodes samples on a thread pool and keeps
PREFETCH collated numpy batches ready.
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
    """Deterministic shuffled index stream of one host (the JAX sampler
    with a single shard)."""

    def __init__(self, num_samples: int, *, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, batch_size: int = 1):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
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

    def __iter__(self) -> Iterator[tuple[List[int], int]]:
        """Yields (indices, real count): the last batch of a non-drop_last
        epoch is repeat-padded to the batch size and carries its real count."""
        idx = np.arange(self.num_samples)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        n_full = len(idx) // self.batch_size
        for b in range(min(self.skip_batches, n_full), n_full):
            yield idx[b * self.batch_size: (b + 1) * self.batch_size].tolist(), self.batch_size
        rem = idx[n_full * self.batch_size:]
        if len(rem) and not self.drop_last and self.skip_batches <= n_full:
            yield np.resize(rem, self.batch_size).tolist(), len(rem)

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)


class DataLoader:
    """Iterable over collated numpy batches; a padded tail batch carries
    `_real_count`."""

    def __init__(self, dataset, *, batch_size: int = 32, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.sampler = ShardedSampler(len(dataset), shuffle=shuffle, seed=seed,
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

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx, real in batches:
                        if stop.is_set():
                            return
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
