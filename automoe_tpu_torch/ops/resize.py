"""Bilinear resize as two matmuls (port of automoe_tpu/ops/resize.py).

Weight construction mirrors jax.image.resize's LINEAR kernel (half-pixel
centers, tent kernel scaled for anti-aliasing on downsample, edge
renormalization), so numerics match the reference preprocessing. With
`antialias=False` it matches torch's F.interpolate(align_corners=False).
The weight builders are numpy and identical to the JAX package's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """[out_size, in_size] row-stochastic tent-kernel interpolation weights."""
    scale = out_size / in_size
    # support radius: widen the tent when minifying (anti-aliasing)
    radius = max(1.0, 1.0 / scale) if antialias else 1.0
    out_idx = np.arange(out_size, dtype=np.float64)
    centers = (out_idx + 0.5) / scale - 0.5  # half-pixel mapping
    j = np.arange(in_size, dtype=np.float64)
    dist = np.abs(j[None, :] - centers[:, None]) / radius
    w = np.clip(1.0 - dist, 0.0, None)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)  # edge renorm
    return w.astype(np.float32)


def resize_weights(
    in_h: int, in_w: int, out_h: int, out_w: int, antialias: bool = True
):
    """Host-side (A_h [out_h,in_h], A_w [out_w,in_w]) interpolation matrices
    as numpy arrays."""
    return (
        _interp_matrix(in_h, out_h, antialias),
        _interp_matrix(in_w, out_w, antialias),
    )


@functools.lru_cache(maxsize=64)
def mean_of_resize_weights(
    in_h: int, in_w: int, out_h: int, out_w: int, antialias: bool = False
):
    """(u [in_h], v [in_w]) such that mean(resize(x)) == u^T x v exactly.

    mean over the resized map is linear: mean_o(A x A'^T) = (mean of A's
    rows) x (mean of A''s rows)^T. Lets the gating extractors pool the
    experts' LOW-RES logits without materialising the upsampled map.
    """
    u = _interp_matrix(in_h, out_h, antialias).mean(axis=0)
    v = _interp_matrix(in_w, out_w, antialias).mean(axis=0)
    return u.astype(np.float32), v.astype(np.float32)


def resize_bilinear(
    x: torch.Tensor,
    out_h: int,
    out_w: int,
    *,
    antialias: bool = True,
    mats=None,
) -> torch.Tensor:
    """[B, H, W, C] → [B, out_h, out_w, C] separable bilinear resize.

    `mats`: optional (A_h, A_w) from `resize_weights`, as numpy arrays or
    as tensors already on x's device (the engine keeps device copies so a
    step uploads nothing but the frame).
    """
    B, H, W, C = x.shape
    if (H, W) == (out_h, out_w):
        return x
    if mats is None:
        mats = resize_weights(H, W, out_h, out_w, antialias)
    ah = torch.as_tensor(mats[0], device=x.device).to(x.dtype)  # [oh, H]
    aw = torch.as_tensor(mats[1], device=x.device).to(x.dtype)  # [ow, W]
    # Contract the axis that makes the SMALLER intermediate first (the
    # same order as the JAX package, so the two round alike).
    if out_h * W <= H * out_w:
        y = torch.einsum("oh,bhwc->bowc", ah, x)
        return torch.einsum("ow,bhwc->bhoc", aw, y)
    y = torch.einsum("ow,bhwc->bhoc", aw, x)
    return torch.einsum("oh,bhwc->bowc", ah, y)
