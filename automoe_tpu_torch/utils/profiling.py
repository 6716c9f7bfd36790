"""Tracing and step timing (port of automoe_tpu/utils/profiling.py:
`trace` and `StepTimer`).

`trace(dir)` records the enclosed block with torch.profiler (host ops,
and the card's kernels and copies when CUDA is present) and writes it to
`<dir>/trace_<pid>_<n>.json`, a Chrome trace that Perfetto and
chrome://tracing open.

On a CUDA device each step is timed by a pair of CUDA events, read once
they have completed, so timing adds no synchronisation. That is stream
time: it spans every gap in which the card waits for the host's launches
of the step, so it is not the card's busy time. On the CPU the
host clock times the step."""
from __future__ import annotations

import contextlib
import itertools
import os
import time
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np
import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Path]:
    """Profile the enclosed block; yields the path the trace will have."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir) / f"trace_{os.getpid()}_{next(_TRACES)}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


class StepTimer:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pending: List = []
        self._times_ms: List[float] = []
        self._t0 = None

    def start(self) -> None:
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._t0, end))
        else:
            self._times_ms.append((time.perf_counter() - self._t0) * 1e3)
        self._t0 = None

    def times_ms(self) -> List[float]:
        """Every timed step so far, in order (waits for pending events)."""
        for a, b in self._pending:
            b.synchronize()
            self._times_ms.append(a.elapsed_time(b))
        self._pending = []
        return list(self._times_ms)

    def stats(self) -> Dict[str, float]:
        """Step-time statistics over the steps after the first (the first
        carries one-time set-up: kernel builds, allocator growth)."""
        t = self.times_ms()
        arr = np.asarray(t[1:] if len(t) > 1 else t)
        if not arr.size:
            return {}
        return {
            "step_ms_p50": float(np.percentile(arr, 50)),
            "step_ms_p95": float(np.percentile(arr, 95)),
            "step_ms_mean": float(arr.mean()),
            "timed_steps": float(arr.size),
            "device_timed": float(self.cuda),
        }
