"""Int8 serving-stem kernels (csrc/stem.cu) and their plain versions.

K3 `s2d_stem_pool_int8`: the s2d stem conv of all experts + bias + ReLU +
per-channel int8 quantize + 3x3/s2 max-pool, writing only the pooled int8
tensor (port of automoe_tpu/ops/pallas_stem.py::_stem_kernel), for a bf16
input or an f32 one (both on the tensor cores; the f32 kernel splits each
value into two TF32 parts and takes three passes, f32-accurate), as the
JAX kernel takes either.
K4 `maxpool3x3s2_int8`: the int8 3x3/s2 SAME max-pool alone (port of
pallas_stem.py::_pool_kernel).

Each kernel is a `torch.library` custom op in the `automoe` namespace
(`torch.ops.automoe.s2d_stem_pool_int8`, `..._f32` for an f32 input,
`maxpool3x3s2_int8`), so `torch.export` keeps it as one node of a traced
program (serving/export.py) and a loaded program launches it. On a CUDA
tensor an op launches its hand-written kernel (compiled at first use by
nvcc into build/torch_ext/, from the sources in this package; ops/_ext.py)
or raises; on a CPU tensor it runs the plain PyTorch version beside it.
The plain versions are what the CPU tests hold against the JAX package,
and what the card's kernels are held against. `LAUNCHES` counts kernel
launches only. The public wrappers call the ops.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from automoe_tpu_torch.ops._ext import check_cuda as _check_cuda
from automoe_tpu_torch.ops._ext import load_library, raise_on

#: kernel launches per wrapper (a plain-version call does not count)
LAUNCHES = {"s2d_stem_pool_int8": 0, "s2d_stem_pool_int8_f32": 0, "maxpool3x3s2_int8": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.automoe_stem_s2d_pool_int8, lib.automoe_stem_s2d_pool_int8_f32):
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = i
    lib.automoe_maxpool3x3s2_int8.argtypes = [p, p, i, i, i, i, p]
    lib.automoe_maxpool3x3s2_int8.restype = i


def build() -> ctypes.CDLL:
    """Compile csrc/stem.cu for sm_90a (once per process) and bind its C
    entry points. Raises if the build fails."""
    return load_library("automoe_stem", "stem.cu", bind=_bind)


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


def _maxpool3x3s2_int8_launch(x: torch.Tensor) -> torch.Tensor:
    """K4 on the card."""
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
    raise_on(err, "maxpool3x3s2_int8")
    LAUNCHES["maxpool3x3s2_int8"] += 1
    return out


@torch.library.custom_op("automoe::maxpool3x3s2_int8", mutates_args=(), device_types="cuda")
def _maxpool3x3s2_int8_op(x: torch.Tensor) -> torch.Tensor:
    return _maxpool3x3s2_int8_launch(x)


_maxpool3x3s2_int8_op.register_kernel("cpu")(maxpool3x3s2_int8_plain)


@_maxpool3x3s2_int8_op.register_fake
def _(x):
    B, H, W, C = x.shape
    return x.new_empty((B, *pool_out_hw(H, W), C), dtype=torch.int8)


def maxpool3x3s2_int8(x: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA, the plain version on the CPU (`automoe::maxpool3x3s2_int8`)."""
    return torch.ops.automoe.maxpool3x3s2_int8(x)


# ---------------------------------------------------------------------------
# K3: fused s2d stem conv + bias + ReLU + quantize + pool
# ---------------------------------------------------------------------------

def quantize_int8(h: torch.Tensor, inv) -> torch.Tensor:
    """clip(round(h * inv), ±127) → int8, in f32 (round half to even)."""
    return torch.clamp(torch.round(h.float() * inv), -127, 127).to(torch.int8)


def s2d_stem_pool_int8_plain(xs: torch.Tensor, w: torch.Tensor,
                             bias: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """xs [B,Hc+4,Wc+4,12], w [192,O] (row (a*4+b)*12+c), bias/inv [O] f32
    → [B,ceil(Hc/2),ceil(Wc/2),O] int8. In the order of the JAX kernel
    (pallas_stem.py::_stem_kernel): the conv in f32 on the bf16 or f32
    inputs (F.conv2d, crop to [:Hc,:Wc]; on the card with TF32 off for an
    f32 reference), bias, ReLU, the 3x3/s2 SAME
    max-pool of the f32 values (its -inf padding never wins: they are
    >= 0), then quantize. For any sign of inv."""
    B, hp, wp, cin = xs.shape
    k = w.float().reshape(4, 4, cin, -1).permute(3, 2, 0, 1)  # OIHW
    h = F.conv2d(xs.float().permute(0, 3, 1, 2), k)[:, :, : hp - 4, : wp - 4]
    h = torch.relu(h + bias.float()[:, None, None])
    pooled = F.max_pool2d(h, 3, 2, 1)
    return quantize_int8(pooled, inv.float()[:, None, None]).permute(0, 2, 3, 1).contiguous()


def _stem_launch(entry: str, key: str, dtype: torch.dtype, xs: torch.Tensor,
                 w: torch.Tensor, bias: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K3 on the card through its C entry point for `dtype` inputs."""
    _check_cuda(key, xs, w, bias, inv)
    B, hp, wp, cin = xs.shape
    O = w.shape[-1]
    if (xs.dtype != dtype or w.dtype != dtype or cin != 12
            or tuple(w.shape) != (192, O) or O % 64
            or bias.dtype != torch.float32 or inv.dtype != torch.float32
            or bias.numel() != O or inv.numel() != O or hp <= 4 or wp <= 4):
        raise ValueError(
            "s2d_stem_pool_int8: need xs [B,H,W,12] and w [192,64k] both bf16 or both "
            f"f32, bias/inv f32 [O]; got xs {xs.dtype} {tuple(xs.shape)}, "
            f"w {w.dtype} {tuple(w.shape)}, bias {bias.dtype}, inv {inv.dtype}"
        )
    out = torch.empty((B, *pool_out_hw(hp - 4, wp - 4), O), dtype=torch.int8,
                      device=xs.device)
    err = getattr(build(), entry)(
        xs.data_ptr(), w.data_ptr(), bias.data_ptr(), inv.data_ptr(),
        out.data_ptr(), B, hp, wp, O,
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    raise_on(err, key)
    LAUNCHES[key] += 1
    return out


def _stem_fake(xs, w, bias, inv):
    B, hp, wp, _ = xs.shape
    return xs.new_empty((B, *pool_out_hw(hp - 4, wp - 4), w.shape[-1]), dtype=torch.int8)


@torch.library.custom_op("automoe::s2d_stem_pool_int8", mutates_args=(), device_types="cuda")
def _s2d_stem_pool_int8_op(xs: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                           inv: torch.Tensor) -> torch.Tensor:
    """K3 on the card, xs and w bf16."""
    return _stem_launch("automoe_stem_s2d_pool_int8", "s2d_stem_pool_int8", torch.bfloat16,
                        xs, w, bias, inv)


@torch.library.custom_op("automoe::s2d_stem_pool_int8_f32", mutates_args=(),
                         device_types="cuda")
def _s2d_stem_pool_int8_f32_op(xs: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                               inv: torch.Tensor) -> torch.Tensor:
    """K3 on the card, xs and w f32."""
    return _stem_launch("automoe_stem_s2d_pool_int8_f32", "s2d_stem_pool_int8_f32",
                        torch.float32, xs, w, bias, inv)


for _op in (_s2d_stem_pool_int8_op, _s2d_stem_pool_int8_f32_op):
    _op.register_kernel("cpu")(s2d_stem_pool_int8_plain)
    _op.register_fake(_stem_fake)


def s2d_stem_pool_int8(xs: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       inv: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA (xs and w both bf16, or both f32; bias, inv f32 of either
    sign), the plain version on the CPU: `automoe::s2d_stem_pool_int8_f32`
    for an f32 xs, else `automoe::s2d_stem_pool_int8`."""
    op = (torch.ops.automoe.s2d_stem_pool_int8_f32 if xs.dtype == torch.float32
          else torch.ops.automoe.s2d_stem_pool_int8)
    return op(xs, w, bias, inv)
