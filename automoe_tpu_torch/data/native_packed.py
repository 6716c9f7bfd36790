"""Native (C++) batch reader for packed caches (port of
automoe_tpu/data/native_packed.py).

Binds csrc/packed_reader.cpp through ctypes; the library is built with g++
at first use into build/torch_ext/ (ops/_ext.py::load_host_library).
`NativePackedDataset` reads the caches `data/packed.py` writes, sequence
and frame caches alike, and adds `read_batch(indices)`: one
multi-threaded mmap gather plus float16 → float32 widening per field in
native code, instead of B Python-level fancy-index copies. The DataLoader
takes `read_batch` whenever a dataset has it.

Unlike the JAX package's factories, nothing falls back to the python
reader: a failed build raises with g++'s output, a directory without a
readable cache raises FileNotFoundError.
"""
from __future__ import annotations

import ctypes
import json
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

from automoe_tpu_torch.ops._ext import load_host_library

# what read_batch materialises per stored dtype code (f32, f16, i32): f16 widens
_OUT_DTYPES = {0: np.float32, 1: np.float32, 2: np.int32}


def _bind(lib: ctypes.CDLL) -> None:
    vp, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    for fn, res, args in (
        ("pr_open", vp, [ctypes.c_char_p]),
        ("pr_num_fields", ctypes.c_int, [vp]),
        ("pr_field_name", ctypes.c_char_p, [vp, ctypes.c_int]),
        ("pr_field_rank", ctypes.c_int, [vp, ctypes.c_int]),
        ("pr_field_shape", None, [vp, ctypes.c_int, i64p]),
        ("pr_field_dtype", ctypes.c_int, [vp, ctypes.c_int]),
        ("pr_num_samples", ctypes.c_int64, [vp]),
        ("pr_read_batch", ctypes.c_int, [vp, ctypes.c_int, i64p, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_float), ctypes.c_int]),
        ("pr_close", None, [vp]),
    ):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args


def load_library() -> ctypes.CDLL:
    """The reader's library, built on first use; raises with g++'s output."""
    return load_host_library("packed_reader", "packed_reader.cpp", bind=_bind)


class NativePackedDataset:
    """Packed-cache dataset backed by the C++ reader: `read_batch(indices)`
    gives a dict of [B, ...] arrays (float32, int32 for integer fields;
    no 'meta', which stays in `self.meta`), `ds[i]` one sample (with its
    'meta' when the cache has them). A batch is gathered on one thread
    per core."""

    def __init__(self, packed_dir):
        self.dir = Path(packed_dir)
        lib = load_library()
        handle = lib.pr_open(str(self.dir).encode())
        if not handle:
            raise FileNotFoundError(f"no readable packed cache at {self.dir}")
        self._lib = lib
        self._handle = handle
        index_path = self.dir / "index.json"
        index = json.loads(index_path.read_text()) if index_path.exists() else {}
        self.meta = index.get("meta", [])
        self.n = int(lib.pr_num_samples(handle))
        self.fields: Dict[str, int] = {}
        self.row_shapes: Dict[str, tuple] = {}
        self.out_dtypes: Dict[str, type] = {}
        for f in range(lib.pr_num_fields(handle)):
            name = lib.pr_field_name(handle, f).decode()
            rank = lib.pr_field_rank(handle, f)
            shape = (ctypes.c_int64 * max(rank, 1))()
            lib.pr_field_shape(handle, f, shape)
            self.fields[name] = f
            self.row_shapes[name] = tuple(shape[i] for i in range(rank))
            self.out_dtypes[name] = _OUT_DTYPES[lib.pr_field_dtype(handle, f)]

    def __len__(self) -> int:
        return self.n

    def read_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        if not self._handle:
            raise ValueError(f"packed cache {self.dir} is closed")
        idx = np.ascontiguousarray(indices, np.int64)
        b = len(idx)
        idx_p = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        out: Dict[str, np.ndarray] = {}
        for name, f in self.fields.items():
            buf = np.empty((b, *self.row_shapes[name]), self.out_dtypes[name])
            rc = self._lib.pr_read_batch(self._handle, f, idx_p, b,
                                         buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                         0)  # 0: one thread per core
            if rc != 0:
                raise ValueError(f"pr_read_batch failed (rc={rc}, field={name}, n={self.n}, "
                                 f"batch={b})")
            out[name] = buf
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        out = {k: v[0] for k, v in self.read_batch([i]).items()}
        if self.meta:
            out["meta"] = self.meta[i]
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.pr_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        if getattr(self, "_handle", None):
            self.close()
