"""Datasets over the reference's per-sample `.pt` caches (port of
automoe_tpu/data/datasets.py without its packed fast path), returning
numpy NHWC samples with boxes and LiDAR padded to static caps.

BDD caches hold an `image_path` (and a `mask_path` for segmentation and
drivable area) decoded with PIL (imported only there), images scaled to
[0,1]; CARLA and nuScenes caches hold the image tensor itself ([3,H,W] or
[H,W,3]), read by torch.load alone. Drivable masks take channel 0 of a
multi-channel mask; CARLA segmentation masks hold raw simulator IDs, and
those outside [0, num_classes) become the ignore label 255 at load time;
CARLA drivable masks map raw IDs to {0 bg, 1 drivable, 2 alternative}
with ID sets the environment may override. nuScenes boxes are devkit
Box-likes (or arrays) turned into [cx,cy,cz,w,l,h,yaw] with 10-way
labels.
"""
from __future__ import annotations

import math
import os
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from automoe_tpu_torch.data.collate import pad_boxes, pad_points
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


def _read_mask_file(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32)


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


class BDDSegmentationDataset:
    """{image_path, mask_path} caches; a path that does not exist resolves
    against a raw root (`raw_root`, else $BDD100K_RAW_ROOT): first as
    given, then its part after "images" under <raw_root>/images."""

    def __init__(self, split_dir, raw_root: Optional[str] = None):
        self.files = _list_pt(Path(split_dir))
        if not self.files:
            raise FileNotFoundError(f"no .pt caches under {split_dir}")
        self.raw_root = raw_root or os.environ.get("BDD100K_RAW_ROOT")

    def __len__(self):
        return len(self.files)

    def _resolve(self, p: str) -> str:
        if Path(p).exists():
            return p
        if self.raw_root:
            cand = Path(self.raw_root) / p
            if cand.exists():
                return str(cand)
            if "images" in p:
                # the separator is stripped: joining an absolute part onto
                # a Path would discard raw_root
                suffix = p.split("images", 1)[1].lstrip(os.sep)
                cand2 = Path(self.raw_root) / "images" / suffix
                if cand2.exists():
                    return str(cand2)
        return p

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = _load_pt(self.files[idx])
        return {
            "image": _read_image_file(self._resolve(s["image_path"])),
            "mask": _read_mask_file(self._resolve(s["mask_path"])),
        }


class BDDDrivableDataset(BDDSegmentationDataset):
    pass  # channel 0 of a multi-channel mask: _read_mask_file


def _normalize_mask(mask) -> np.ndarray:
    arr = _to_np(mask)
    if arr.ndim == 3:
        if arr.shape[-1] in (3, 4):
            arr = arr[..., 0]
        elif arr.shape[0] in (3, 4):
            arr = arr[0]
        else:
            arr = np.squeeze(arr)
    return arr.astype(np.int32)


class CarlaSegmentationDataset:
    """Per-frame CARLA caches {image, mask} (recursive *.pt glob) whose
    masks hold raw simulator semantic IDs: IDs outside [0, num_classes)
    become 255 (ignored), here at load time; a frame without a mask is
    all 255."""

    def __init__(self, split_dir, num_classes: int = 19):
        self.files = _list_pt(Path(split_dir), recursive=True)
        if not self.files:
            raise FileNotFoundError(f"no .pt caches under {split_dir}")
        self.num_classes = int(num_classes)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = _load_pt(self.files[idx])
        image = _image_hwc(s["image"])
        mask = s.get("mask")
        if mask is None:
            mask = np.full(image.shape[:2], 255, np.int32)
        else:
            mask = _normalize_mask(mask)
            invalid = (mask < 0) | ((mask >= self.num_classes) & (mask != 255))
            if invalid.any():
                mask = np.where(invalid, 255, mask).astype(np.int32)
        return {"image": image, "mask": mask}


def _parse_ids_env(key: str) -> Optional[List[int]]:
    """Comma-separated integer IDs from the environment; None when unset,
    empty or malformed."""
    val = os.environ.get(key)
    if not val:
        return None
    try:
        return [int(x) for x in val.split(",") if x.strip()]
    except ValueError:
        return None


class CarlaDrivableDataset(CarlaSegmentationDataset):
    """Raw CARLA IDs → {0 bg, 1 drivable, 2 alternative}. The ID sets are
    the arguments, else $CARLA_DRIVABLE_IDS / $CARLA_ALTERNATIVE_IDS, else
    [7] (road) and []; a frame without a mask is all 255."""

    def __init__(self, split_dir, drivable_ids=None, alternative_ids=None):
        super().__init__(split_dir)
        env_d = _parse_ids_env("CARLA_DRIVABLE_IDS")
        env_a = _parse_ids_env("CARLA_ALTERNATIVE_IDS")
        self.drivable_ids = (drivable_ids if drivable_ids is not None
                             else (env_d if env_d is not None else [7]))
        self.alternative_ids = (alternative_ids if alternative_ids is not None
                                else (env_a if env_a is not None else []))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = _load_pt(self.files[idx])
        image = _image_hwc(s["image"])
        raw = s.get("mask")
        if raw is None:
            mask = np.full(image.shape[:2], 255, np.int32)
        else:
            raw = _normalize_mask(raw)
            mask = np.zeros_like(raw, np.int32)
            mask[np.isin(raw, self.drivable_ids)] = 1
            mask[np.isin(raw, self.alternative_ids)] = 2
        return {"image": image, "mask": mask}


NUSCENES_CLASSES = {
    "car": 0, "truck": 1, "bus": 2, "trailer": 3, "construction_vehicle": 4,
    "pedestrian": 5, "motorcycle": 6, "bicycle": 7, "traffic_cone": 8,
    "barrier": 9,
}

_CANONICAL = (
    ("vehicle.car", "car"), ("vehicle.truck", "truck"), ("vehicle.bus", "bus"),
    ("vehicle.trailer", "trailer"), ("vehicle.construction", "construction_vehicle"),
    ("construction_vehicle", "construction_vehicle"), ("human.pedestrian", "pedestrian"),
    ("vehicle.motorcycle", "motorcycle"), ("vehicle.bicycle", "bicycle"),
    ("movable_object.trafficcone", "traffic_cone"), ("traffic_cone", "traffic_cone"),
    ("movable_object.barrier", "barrier"), ("barrier", "barrier"),
)


def _extract_yaw(quat) -> float:
    """Yaw of a devkit Quaternion-like: `yaw_pitch_roll[0]`, else
    atan2(R10, R00) of its rotation matrix, else 0."""
    ypr = getattr(quat, "yaw_pitch_roll", None)
    if ypr is not None:
        try:
            return float(ypr[0])
        except (TypeError, ValueError, IndexError):
            pass
    R = getattr(quat, "rotation_matrix", None)
    if R is not None:
        try:
            return math.atan2(float(R[1][0]), float(R[0][0]))
        except (TypeError, ValueError, IndexError):
            pass
    return 0.0


def _canonical_class(name: str) -> Optional[str]:
    n = name.lower()
    for prefix, canon in _CANONICAL:
        if n.startswith(prefix):
            return canon
    return None


def boxes_to_arrays(box_list) -> Tuple[np.ndarray, np.ndarray]:
    """Devkit Box-likes (center, wlh, orientation, name) → ([N,7] float32
    [cx,cy,cz,w,l,h,yaw], [N] int32 labels); boxes of other classes are
    dropped."""
    feats, labels = [], []
    for b in box_list or []:
        cname = _canonical_class(getattr(b, "name", "") or "")
        if cname is None:
            continue
        center = [float(x) for x in list(b.center)]
        wlh = [float(x) for x in list(b.wlh)]
        feats.append(center + wlh + [_extract_yaw(getattr(b, "orientation", None))])
        labels.append(NUSCENES_CLASSES[cname])
    if not feats:
        return np.zeros((0, 7), np.float32), np.zeros((0,), np.int32)
    return np.asarray(feats, np.float32), np.asarray(labels, np.int32)


class NuScenesDataset:
    """Per-sample {image, lidar [P,3], intrinsics, boxes, labels, token}
    caches: LiDAR zero-padded (or truncated) to lidar_cap points, boxes to
    box_cap; `boxes` is a list of Box-likes or an [M,7] array with
    `labels`. The string `token` passes through batching as a list."""

    def __init__(self, cache_dir, lidar_cap: int = 8192, box_cap: int = 64):
        self.files = _list_pt(Path(cache_dir))
        if not self.files:
            raise FileNotFoundError(f"no .pt caches under {cache_dir}")
        self.lidar_cap = lidar_cap
        self.box_cap = box_cap

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        s = _load_pt(self.files[idx])
        raw_boxes = s.get("boxes", [])
        if isinstance(raw_boxes, (list, tuple)):
            b, lab = boxes_to_arrays(raw_boxes)
        else:
            b = _to_np(raw_boxes).astype(np.float32).reshape(-1, 7)
            lab = _to_np(s["labels"]).astype(np.int32).reshape(-1)
        boxes, labels = pad_boxes(b, lab, self.box_cap, box_dim=7)
        return {
            "image": _image_hwc(s["image"]),
            "lidar": pad_points(_to_np(s["lidar"]).astype(np.float32), self.lidar_cap),
            "intrinsics": _to_np(s["intrinsics"]).astype(np.float32),
            "boxes": boxes,
            "labels": labels,
            "token": s.get("token", ""),
        }


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
