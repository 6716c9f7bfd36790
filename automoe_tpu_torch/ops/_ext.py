"""Build and bind the port's native sources (automoe_tpu_torch/csrc/):
the CUDA kernels (*.cu, nvcc) and the host-side packed-cache reader
(packed_reader.cpp, g++).

Each source has a plain C interface (no PyTorch headers), so it is compiled
straight into a shared library and bound with ctypes: a few seconds per
source. The library lands in build/torch_ext/ under a name that carries a
hash of the source and flags, so an unchanged source is compiled once.
Nothing is compiled when a module is imported; a caller may build several
sources at once from its own threads. A failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = CUDA_HOME or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found under {home}: the CUDA kernels cannot be built")
    return str(path)


def _build_and_load(name: str, source: str, compiler: str, flags: Sequence[str],
                    libs: Sequence[str], bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _lock:
        if name in _libs:
            return _libs[name]
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes() + " ".join([compiler, *flags, *libs]).encode()
                          ).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}_{digest}.so"
    if not out.exists():
        # the compiler runs outside the lock: two sources compile at once; two
        # builds of one source write their own temporary file and the same result
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        res = subprocess.run([compiler, *flags, "-o", str(tmp), str(src), *libs],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{Path(compiler).name} failed on {src}:\n{res.stdout}\n"
                               f"{res.stderr}")
        tmp.replace(out)
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(out))
            bind(lib)
            _libs[name] = lib
        return _libs[name]


def load_library(name: str, source: str, extra_flags: Sequence[str] = (),
                 bind: Callable[[ctypes.CDLL], None] = lambda lib: None) -> ctypes.CDLL:
    """Compile the CUDA source csrc/<source> with nvcc once per process (and
    once per content on disk), load it, and let `bind` declare its entry
    points. Raises with nvcc's output if the build fails."""
    return _build_and_load(name, source, nvcc_path(), NVCC_FLAGS + list(extra_flags), (),
                           bind)


def load_host_library(name: str, source: str,
                      bind: Callable[[ctypes.CDLL], None] = lambda lib: None) -> ctypes.CDLL:
    """load_library for host C++ (csrc/<source>, g++ with pthreads)."""
    return _build_and_load(name, source, "g++", GXX_FLAGS, ("-lpthread",), bind)


def check_cuda(name: str, *tensors) -> None:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CUDA or the CPU, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")


def raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
