"""Datasets over the reference's per-sample `.pt` caches (port of the
detection and CARLA-sequence parts of automoe_tpu/data/datasets.py),
returning numpy NHWC samples with boxes padded to a static cap.

BDD caches hold an `image_path` decoded with PIL (imported only there) and
scaled to [0,1]; CARLA caches hold the image tensor itself ([3,H,W] or
[H,W,3]), read by torch.load alone.
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from automoe_tpu_torch.data.collate import pad_boxes
from automoe_tpu_torch.data.ego import world_to_ego_xy


def _load_pt(path) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _image_hwc(x) -> np.ndarray:
    """torch [3,H,W] or numpy [H,W,3] → float32 [H,W,3]."""
    arr = _to_np(x).astype(np.float32)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))
    return arr


def _read_image_file(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _list_pt(dirpath: Path, recursive: bool = False) -> List[Path]:
    return sorted(dirpath.rglob("*.pt") if recursive else dirpath.glob("*.pt"))


def _boxes_labels(s: Dict[str, Any], cap: int):
    raw_b, raw_l = s.get("bboxes"), s.get("labels")
    b = (_to_np(raw_b).astype(np.float32).reshape(-1, 4) if raw_b is not None
         else np.zeros((0, 4), np.float32))
    lab = (_to_np(raw_l).astype(np.int32).reshape(-1) if raw_l is not None
           else np.zeros((0,), np.int32))
    return pad_boxes(b, lab, cap)


class BDDDetectionDataset:
    """Per-image {image_path, bboxes xyxy, labels} caches + static box cap."""

    def __init__(self, split_dir, box_cap: int = 48):
        self.files = _list_pt(Path(split_dir))
        if not self.files:
            raise FileNotFoundError(f"no .pt caches under {split_dir}")
        self.box_cap = box_cap

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = _load_pt(self.files[idx])
        boxes, labels = pad_boxes(_to_np(s["bboxes"]).astype(np.float32).reshape(-1, 4),
                                  _to_np(s["labels"]).astype(np.int32).reshape(-1),
                                  self.box_cap)
        return {"image": _read_image_file(s["image_path"]), "bboxes": boxes, "labels": labels}


class CarlaDetectionDataset:
    """Per-frame CARLA caches under run_*/ (recursive *.pt glob):
    {image, bboxes, labels}, boxes optional."""

    def __init__(self, split_dir, box_cap: int = 48):
        self.files = _list_pt(Path(split_dir), recursive=True)
        if not self.files:
            raise FileNotFoundError(f"no .pt caches under {split_dir}")
        self.box_cap = box_cap

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = _load_pt(self.files[idx])
        boxes, labels = _boxes_labels(s, self.box_cap)
        return {"image": _image_hwc(s["image"]), "bboxes": boxes, "labels": labels}


class CarlaSequenceDataset:
    """Sliding windows (t, t+1..t+horizon) over per-run CARLA frames
    (`run_*/NNNN.pt`, each with `image` and `vehicle_state` {location,
    rotation, speed_kmh, control}) with ego-frame waypoint targets, the
    future speed profile and controls, and the optional `context` vector
    (weather ∥ traffic_density of frame t)."""

    def __init__(self, split_dir, *, horizon: int = 8, stride: int = 1,
                 include_context: bool = True, frame_cache_size: int = 256):
        self.root = Path(split_dir)
        if not self.root.exists():
            raise FileNotFoundError(f"split dir not found: {self.root}")
        self.horizon = int(horizon)
        self.stride = max(1, int(stride))
        self.include_context = include_context
        # index once: {run_dir: [frame files]}
        self.run_files: Dict[Path, List[Path]] = {}
        self.index: List[Tuple[Path, int]] = []
        runs = sorted(d for d in self.root.iterdir()
                      if d.is_dir() and d.name.startswith("run_"))
        for run in runs:
            files = _list_pt(run)
            self.run_files[run] = files
            for t in range(0, len(files) - (1 + self.horizon) + 1, self.stride):
                self.index.append((run, t))
        if not self.index:
            raise RuntimeError(f"no valid windows under {self.root}")
        # neighbouring windows share frames: a per-instance bounded cache
        self._load = lru_cache(maxsize=frame_cache_size)(_load_pt)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        run, t = self.index[idx]
        files = self.run_files[run]
        current = self._load(files[t])
        futures = [self._load(files[t + k]) for k in range(1, self.horizon + 1)]

        vs = current["vehicle_state"]
        loc_t = _to_np(vs["location"]).astype(np.float32)
        yaw_deg = float(_to_np(vs["rotation"]).astype(np.float32)[1])
        future_xy = np.stack([_to_np(f["vehicle_state"]["location"])[:2]
                              for f in futures]).astype(np.float32)
        speeds = np.asarray([float(_to_np(f["vehicle_state"]["speed_kmh"])) for f in futures],
                            np.float32)
        controls = np.stack([_to_np(f["vehicle_state"]["control"]).astype(np.float32)
                             for f in futures])  # [H,3] = [throttle, steer, brake]
        out: Dict[str, Any] = {
            "image": _image_hwc(current["image"]),
            "waypoints": world_to_ego_xy(future_xy, loc_t[:2], yaw_deg),  # [H,2]
            "speed": speeds,
            "throttle": controls[:, 0],
            "steering": controls[:, 1],
            "brake": controls[:, 2],
            "meta": {
                "run_id": current.get("meta", {}).get("run_id", run.name),
                "frame_id": int(current.get("meta", {}).get("frame_id", t)),
            },
        }
        if self.include_context and isinstance(current.get("context"), dict):
            parts = [_to_np(v).astype(np.float32).reshape(-1)
                     for v in (current["context"].get(k) for k in ("weather", "traffic_density"))
                     if v is not None]
            if parts:
                out["context"] = np.concatenate(parts)
        return out
