"""On-device data augmentation for the train step (port of
automoe_tpu/ops/augment.py). Off by default: the reference trainers
augment nothing.

Per sample, on the batch already on the device:
  * random resized crop: a window of scale s in `scale_range` at a random
    offset inside the frame, resampled back to (H, W) bilinearly as two
    separable gathers + lerps (align_corners=False coordinates); masks
    ride the same window with nearest sampling; boxes are remapped
    analytically;
  * horizontal flip with probability `hflip_prob`;
  * color jitter: brightness, contrast and saturation factors, linear
    (no clipping: the loaders hand over normalized floats).

A box that leaves the crop, or shrinks below `min_box_px` in either
side, gets label -1, the padding label the set losses already ignore.

Parameters are drawn on the host from an explicit `torch.Generator`
(`sample_params`), so a (seed, step) gives the same augmentation on any
device and a resumed run augments as an unbroken one. The draws are not
jax.random's: parity with the JAX package holds on shared parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    hflip_prob: float = 0.5
    #: random-resized-crop scale range; (1.0, 1.0) disables cropping
    scale_range: Tuple[float, float] = (0.8, 1.0)
    brightness: float = 0.2  # factor in [1-b, 1+b]; 0 disables
    contrast: float = 0.2
    saturation: float = 0.2
    #: boxes thinner than this (pixels, after the crop) become ignore (-1)
    min_box_px: float = 2.0


def sample_params(generator: torch.Generator, batch: int,
                  cfg: AugmentConfig) -> Dict[str, torch.Tensor]:
    """Per-sample parameters on the CPU: scale, offsets (as a fraction of
    the slack H − s·H, so the window stays inside the frame), flip, and
    the three jitter factors."""
    u = torch.rand(batch, 7, generator=generator)
    lo, hi = cfg.scale_range
    jit = u[:, 4:] * 2.0 - 1.0
    return {
        "scale": lo + (hi - lo) * u[:, 0], "off_y": u[:, 1], "off_x": u[:, 2],
        "flip": u[:, 3] < cfg.hflip_prob,
        "brightness": 1.0 + cfg.brightness * jit[:, 0],
        "contrast": 1.0 + cfg.contrast * jit[:, 1],
        "saturation": 1.0 + cfg.saturation * jit[:, 2],
    }


_KEYS = ("scale", "off_y", "off_x", "flip", "brightness", "contrast", "saturation")


def params_to(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """`sample_params` output on `device`: one pinned copy of all seven
    columns, so the copy does not wait on the device's queue."""
    device = torch.device(device)
    if device.type == "cpu":
        return params
    packed = torch.stack([params[k].float() for k in _KEYS], 1)
    packed = packed.pin_memory().to(device, non_blocking=True)
    out = {k: packed[:, i] for i, k in enumerate(_KEYS)}
    out["flip"] = out["flip"] > 0.5
    return out


def _axis_coords(n: int, start: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[B, n] source coordinates of n output pixels sampling a window of
    n·scale source pixels from `start` (align_corners=False)."""
    i = torch.arange(n, dtype=torch.float32, device=start.device)
    return start[:, None] + (i[None] + 0.5) * scale[:, None] - 0.5


def _take(img: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """img[b].take(idx[b], axis - 1) for each sample b; idx [B, n]."""
    shape = [1] * img.ndim
    shape[0], shape[axis] = idx.shape
    full = list(img.shape)
    full[axis] = idx.shape[1]
    return torch.gather(img, axis, idx.reshape(shape).expand(full))


def _take_lerp(img: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    n = img.shape[axis]
    c0 = torch.floor(coords)
    t = coords - c0
    i0 = torch.clamp(c0.long(), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    a, b = _take(img, i0, axis), _take(img, i1, axis)
    shape = [1] * img.ndim
    shape[0], shape[axis] = t.shape
    t = t.reshape(shape).to(img.dtype)
    return a * (1 - t) + b * t


def _take_nearest(img: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    return _take(img, torch.clamp(torch.round(coords).long(), 0, img.shape[axis] - 1), axis)


def _crop(img: torch.Tensor, params: Dict[str, torch.Tensor], nearest: bool) -> torch.Tensor:
    """Resample [B, H, W, ...] from each sample's window back to (H, W)."""
    H, W = img.shape[1], img.shape[2]
    s = params["scale"]
    y0 = params["off_y"] * H * (1.0 - s)
    x0 = params["off_x"] * W * (1.0 - s)
    take = _take_nearest if nearest else _take_lerp
    return take(take(img, _axis_coords(H, y0, s), 1), _axis_coords(W, x0, s), 2)


def _flip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(flip.reshape(-1, *[1] * (img.ndim - 1)), img.flip(2), img)


def augment_images(image: torch.Tensor, params: Dict[str, torch.Tensor], *,
                   color: bool = True) -> torch.Tensor:
    """[B, H, W, C] float images through crop, flip (and color jitter)."""
    out = _flip(_crop(image, params, nearest=False), params["flip"])
    if color:
        col = lambda k: params[k].reshape(-1, 1, 1, 1).to(out.dtype)  # noqa: E731
        x = out * col("brightness")
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) * col("contrast") + mean
        gray = x.mean(dim=-1, keepdim=True)
        out = gray + (x - gray) * col("saturation")
    return out.to(image.dtype)


def augment_masks(mask: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, H, W] integer masks through the same window, nearest-sampled."""
    return _flip(_crop(mask, params, nearest=True), params["flip"])


def transform_boxes(bboxes: torch.Tensor, labels: torch.Tensor,
                    params: Dict[str, torch.Tensor], hw: Tuple[int, int],
                    min_box_px: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, cap, 4] xyxy pixel boxes through each sample's crop and flip,
    in the same (H, W) frame (the window [x0, x0 + s·W] maps to [0, W]).
    Boxes clipped below `min_box_px` in either side get label -1."""
    H, W = hw
    s = params["scale"][:, None]
    y0 = (params["off_y"] * H)[:, None] * (1.0 - s)
    x0 = (params["off_x"] * W)[:, None] * (1.0 - s)
    x1, y1, x2, y2 = bboxes.unbind(-1)
    x1c = torch.clamp((x1 - x0) / s, 0.0, float(W))
    x2c = torch.clamp((x2 - x0) / s, 0.0, float(W))
    y1c = torch.clamp((y1 - y0) / s, 0.0, float(H))
    y2c = torch.clamp((y2 - y0) / s, 0.0, float(H))
    flip = params["flip"][:, None]
    fx1 = torch.where(flip, W - x2c, x1c)
    fx2 = torch.where(flip, W - x1c, x2c)
    alive = ((fx2 - fx1) >= min_box_px) & ((y2c - y1c) >= min_box_px)
    return (torch.stack([fx1, y1c, fx2, y2c], -1).to(bboxes.dtype),
            torch.where(alive, labels, torch.full_like(labels, -1)))


def augment_detection(batch: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                      cfg: Optional[AugmentConfig] = None) -> Dict[str, torch.Tensor]:
    """{image, bboxes, labels} through one consistent augmentation."""
    cfg = cfg or AugmentConfig()
    H, W = batch["image"].shape[1], batch["image"].shape[2]
    out = dict(batch)
    out["image"] = augment_images(batch["image"], params)
    out["bboxes"], out["labels"] = transform_boxes(batch["bboxes"], batch["labels"], params,
                                                   (H, W), min_box_px=cfg.min_box_px)
    return out


def augment_segmentation(batch: Dict[str, torch.Tensor],
                         params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{image, mask} through one consistent augmentation (mask nearest)."""
    out = dict(batch)
    out["image"] = augment_images(batch["image"], params)
    out["mask"] = augment_masks(batch["mask"], params)
    return out
