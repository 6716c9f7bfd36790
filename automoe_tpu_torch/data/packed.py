"""Packed caches: memory-mapped, precomputed columns (port of
automoe_tpu/data/packed.py).

The reference's CARLA sequence loader re-globs the run directory and
loads H+1 full frames for every sample; its frame loaders decode an image
from disk per sample every epoch. Packing pays that once and stores one
columnar `.npy` per field plus `index.json`; a batch is then one sliced
memmap read (no decode, no pickle, no glob). The files are byte-identical
to the JAX package's for the same dataset, so either package reads the
other's caches.

Sequence layout: <out_dir>/{image.npy (float16 [N,H,W,3] NHWC),
waypoints.npy, speed.npy, throttle.npy, steering.npy, brake.npy,
context.npy, index.json}. Frame layout (`pack_frames`): one `.npy` per
array field of a sample, images of at least 4096 elements a row float16,
other floats float32, integers int32.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_FIELDS = ("image", "waypoints", "speed", "throttle", "steering", "brake", "context")


def pack_carla_sequences(split_dir, out_dir, *, horizon: int = 8, stride: int = 1) -> int:
    """Convert a reference-format CARLA split into a packed sequence cache;
    returns the number of windows."""
    from automoe_tpu_torch.data.datasets import CarlaSequenceDataset

    ds = CarlaSequenceDataset(split_dir, horizon=horizon, stride=stride)
    n = len(ds)
    if n == 0:
        return 0
    first = ds[0]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    shapes = {
        "image": (n, *first["image"].shape),
        "waypoints": (n, horizon, 2),
        "speed": (n, horizon),
        "throttle": (n, horizon),
        "steering": (n, horizon),
        "brake": (n, horizon),
    }
    dtypes = {k: np.float32 for k in shapes}
    dtypes["image"] = np.float16
    if "context" in first:
        shapes["context"] = (n, *first["context"].shape)
        dtypes["context"] = np.float32

    mm = {k: np.lib.format.open_memmap(out / f"{k}.npy", mode="w+", dtype=dtypes[k],
                                       shape=shapes[k])
          for k in shapes}
    metas = []
    for i in range(n):
        s = ds[i]
        for k in shapes:
            mm[k][i] = s[k]
        metas.append(s["meta"])
    for m in mm.values():
        m.flush()
    (out / "index.json").write_text(json.dumps({"n": n, "horizon": horizon, "meta": metas}))
    return n


class PackedSequenceDataset:
    """CarlaSequenceDataset over a packed sequence cache (python memmap
    reader); `NativePackedDataset` is the faster drop-in."""

    def __init__(self, packed_dir):
        self.dir = Path(packed_dir)
        index = json.loads((self.dir / "index.json").read_text())
        self.n = index["n"]
        self.horizon = index["horizon"]
        self.meta = index["meta"]
        self._mm: Dict[str, Optional[np.ndarray]] = {}
        for k in _FIELDS:
            path = self.dir / f"{k}.npy"
            self._mm[k] = np.load(path, mmap_mode="r") if path.exists() else None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        out = {k: np.asarray(v[i], np.float32) for k, v in self._mm.items() if v is not None}
        out["meta"] = self.meta[i]
        return out

    def read_batch(self, indices) -> Dict[str, np.ndarray]:
        """Whole-batch gather (the loader's fast path); no 'meta', which
        stays host-side in `self.meta`."""
        idx = np.asarray(indices, np.int64)
        return {k: v[idx].astype(np.float32) for k, v in self._mm.items() if v is not None}


#: image fields at least this many elements a row are stored float16
#: (half the disk and read volume; normalised pixels tolerate it); other
#: floats stay float32 (LiDAR coordinates would lose metres in f16) and
#: integers (labels, masks) are int32
_F16_MIN_ROW_ELEMS = 4096


def _pack_dtype(name: str, arr: np.ndarray) -> np.dtype:
    if np.issubdtype(arr.dtype, np.integer):
        return np.int32
    if "image" in name and arr.size >= _F16_MIN_ROW_ELEMS:
        return np.float16
    return np.float32


def pack_frames(dataset, out_dir) -> int:
    """Pack any fixed-shape frame dataset (samples are dicts of arrays:
    BDD / CARLA detection, segmentation and drivable, nuScenes) into a
    columnar memmap cache, one `.npy` per array field plus `index.json`;
    non-array entries (paths, tokens, metas) are skipped. Returns N."""
    n = len(dataset)
    if n == 0:
        return 0
    first = dataset[0]
    fields = {k: v for k, v in first.items()
              if isinstance(v, np.ndarray) and v.dtype != object}
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    mm = {k: np.lib.format.open_memmap(out / f"{k}.npy", mode="w+",
                                       dtype=_pack_dtype(k, v), shape=(n, *v.shape))
          for k, v in fields.items()}
    for i in range(n):
        s = dataset[i] if i else first
        for k in mm:
            mm[k][i] = s[k]
    for m in mm.values():
        m.flush()
    (out / "index.json").write_text(json.dumps({"n": n, "kind": "frames"}))
    return n


class PackedFrameDataset:
    """Reader for `pack_frames` caches (python memmap): float16 fields
    widen to float32, int32 fields stay int32. `read_batch` is the
    loader's fast path; `NativePackedDataset` is the faster drop-in."""

    def __init__(self, packed_dir):
        self.dir = Path(packed_dir)
        index = json.loads((self.dir / "index.json").read_text())
        self.n = index["n"]
        self._mm = {p.stem: np.load(p, mmap_mode="r") for p in sorted(self.dir.glob("*.npy"))}

    @staticmethod
    def _out_dtype(arr) -> np.dtype:
        return np.int32 if np.issubdtype(arr.dtype, np.integer) else np.float32

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v[i], self._out_dtype(v)) for k, v in self._mm.items()}

    def read_batch(self, indices) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        return {k: v[idx].astype(self._out_dtype(v)) for k, v in self._mm.items()}
