"""Fixed-shape padded collates (port of automoe_tpu/data/collate.py):
boxes pad to a static cap, labels with -1, LiDAR with zero points;
over-cap boxes and points are truncated. Padded points are not masked
later: the PointNet's max-pool sees them, as in the JAX package."""
from __future__ import annotations

import warnings
from typing import Dict, List

import numpy as np


def pad_boxes(boxes: np.ndarray, labels: np.ndarray, cap: int, box_dim: int = 4,
              box_fill: float = -1.0) -> tuple[np.ndarray, np.ndarray]:
    out_b = np.full((cap, box_dim), box_fill, np.float32)
    out_l = np.full((cap,), -1, np.int32)
    n = min(len(labels), cap)
    if n:
        out_b[:n] = boxes[:n]
        out_l[:n] = labels[:n]
    return out_b, out_l


def pad_points(points: np.ndarray, cap: int, dim: int = 3) -> np.ndarray:
    out = np.zeros((cap, dim), np.float32)
    n = min(len(points), cap)
    if n:
        out[:n] = points[:n]
    return out


def stack_batch(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack the keys every sample has (warning about the others); non-array
    values pass through as lists."""
    common = set(samples[0])
    union = set(samples[0])
    for s in samples[1:]:
        common &= set(s)
        union |= set(s)
    dropped = union - common
    if dropped:
        warnings.warn(f"stack_batch: dropping keys {sorted(dropped)} missing from "
                      "some samples in the batch", stacklevel=2)
    out = {}
    for k in (k for k in samples[0] if k in common):
        if isinstance(samples[0][k], np.ndarray):
            out[k] = np.stack([s[k] for s in samples], axis=0)
        else:
            out[k] = [s[k] for s in samples]
    return out
