"""Int8 serving-stem kernels (csrc/stem.cu) and their plain versions.

K3 `s2d_stem_pool_int8`: the s2d stem conv of all experts + bias + ReLU +
per-channel int8 quantize + 3x3/s2 max-pool, writing only the pooled int8
tensor (port of automoe_tpu/ops/pallas_stem.py::_stem_kernel).
K4 `maxpool3x3s2_int8`: the int8 3x3/s2 SAME max-pool alone (port of
pallas_stem.py::_pool_kernel).

On a CUDA tensor each wrapper launches its hand-written kernel (built at
first use with torch.utils.cpp_extension.load into build/torch_ext/, from
the sources in this package) or raises; on a CPU tensor it runs the plain
PyTorch version beside it. The plain versions are what the CPU tests hold
against the JAX package, and what the card's kernels are held against.
`LAUNCHES` counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
CUDA_FLAGS = [
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    # the sources use the bf16 intrinsics only; lift torch's ban on the
    # implicit conversions so cuda_bf16.h / mma.h compile unchanged
    "-U__CUDA_NO_HALF_OPERATORS__",
    "-U__CUDA_NO_HALF_CONVERSIONS__",
    "-U__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-U__CUDA_NO_HALF2_OPERATORS__",
]

#: kernel launches per wrapper (a plain-version call does not count)
LAUNCHES = {"s2d_stem_pool_int8": 0, "maxpool3x3s2_int8": 0}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile csrc/stem.cu for sm_90a (once per process) and bind its C
    entry points. Raises if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(
                name="automoe_stem",
                sources=[str(_CSRC / "stem.cu")],
                extra_cuda_cflags=CUDA_FLAGS,
                build_directory=str(BUILD_DIR),
                is_python_module=False,
                verbose=verbose,
            )
            if not isinstance(path, str):
                path = str(BUILD_DIR / "automoe_stem.so")
            lib = ctypes.CDLL(path)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.automoe_stem_s2d_pool_int8.argtypes = [p, p, p, p, p, i, i, i, i, p]
            lib.automoe_maxpool3x3s2_int8.argtypes = [p, p, i, i, i, i, p]
            lib.automoe_stem_s2d_pool_int8.restype = i
            lib.automoe_maxpool3x3s2_int8.restype = i
            _lib = lib
    return _lib


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CUDA or the CPU, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def pool_out_hw(h: int, w: int):
    """Output size of a 3x3/s2 SAME (pad 1) pool."""
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


# ---------------------------------------------------------------------------
# K4: 3x3/s2 SAME max-pool of int8 NHWC
# ---------------------------------------------------------------------------

def maxpool3x3s2_int8_plain(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] int8 → [B,ceil(H/2),ceil(W/2),C]: reduce_window(max) with
    a -128 pad, as nine strided slices."""
    B, H, W, C = x.shape
    ho, wo = pool_out_hw(H, W)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=-128)
    out = None
    for a in range(3):
        for b in range(3):
            s = xp[:, a: a + 2 * ho - 1: 2, b: b + 2 * wo - 1: 2]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


def maxpool3x3s2_int8(x: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return maxpool3x3s2_int8_plain(x)
    _check_cuda("maxpool3x3s2_int8", x)
    if x.dtype != torch.int8 or x.ndim != 4 or x.shape[-1] % 16:
        raise ValueError(f"maxpool3x3s2_int8: need int8 [B,H,W,16k], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    out = torch.empty((B, *pool_out_hw(H, W), C), dtype=torch.int8, device=x.device)
    err = build().automoe_maxpool3x3s2_int8(
        x.data_ptr(), out.data_ptr(), B, H, W, C,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "maxpool3x3s2_int8")
    LAUNCHES["maxpool3x3s2_int8"] += 1
    return out


# ---------------------------------------------------------------------------
# K3: fused s2d stem conv + bias + ReLU + quantize + pool
# ---------------------------------------------------------------------------

def quantize_int8(h: torch.Tensor, inv) -> torch.Tensor:
    """clip(round(h * inv), ±127) → int8, in f32 (round half to even)."""
    return torch.clamp(torch.round(h.float() * inv), -127, 127).to(torch.int8)


def s2d_stem_pool_int8_plain(xs: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """xs [B,Hc+4,Wc+4,12], w [192,O] (row (a*4+b)*12+c), bias/inv [O] f32
    → [B,ceil(Hc/2),ceil(Wc/2),O] int8. The conv runs in f32 on the
    (bf16-exact) inputs: F.conv2d, crop to [:Hc,:Wc], bias, ReLU,
    quantize, then the 3x3/s2 max-pool."""
    B, hp, wp, cin = xs.shape
    k = w.float().reshape(4, 4, cin, -1).permute(3, 2, 0, 1)  # OIHW
    h = F.conv2d(xs.float().permute(0, 3, 1, 2), k)[:, :, : hp - 4, : wp - 4]
    h = torch.relu(h + bias.float()[:, None, None])
    hq = quantize_int8(h, inv.float()[:, None, None])
    return maxpool3x3s2_int8_plain(hq.permute(0, 2, 3, 1))


def s2d_stem_pool_int8(xs: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       inv: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA (xs, w bf16; bias, inv f32), the plain version on the CPU."""
    if xs.device.type == "cpu":
        return s2d_stem_pool_int8_plain(xs, w, bias, inv)
    _check_cuda("s2d_stem_pool_int8", xs, w, bias, inv)
    B, hp, wp, cin = xs.shape
    O = w.shape[-1]
    if (xs.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or cin != 12
            or tuple(w.shape) != (192, O) or O % 64
            or bias.dtype != torch.float32 or inv.dtype != torch.float32
            or bias.numel() != O or inv.numel() != O or hp <= 4 or wp <= 4):
        raise ValueError(
            "s2d_stem_pool_int8: need xs bf16 [B,H,W,12], w bf16 [192,64k], "
            f"bias/inv f32 [O]; got xs {xs.dtype} {tuple(xs.shape)}, "
            f"w {w.dtype} {tuple(w.shape)}, bias {bias.dtype}, inv {inv.dtype}"
        )
    out = torch.empty((B, *pool_out_hw(hp - 4, wp - 4), O), dtype=torch.int8,
                      device=xs.device)
    err = build().automoe_stem_s2d_pool_int8(
        xs.data_ptr(), w.data_ptr(), bias.data_ptr(), inv.data_ptr(),
        out.data_ptr(), B, hp, wp, O,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    _raise_on(err, "s2d_stem_pool_int8")
    LAUNCHES["s2d_stem_pool_int8"] += 1
    return out
