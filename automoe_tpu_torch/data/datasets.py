"""Detection datasets over the reference's per-sample `.pt` caches (port
of the detection part of automoe_tpu/data/datasets.py), returning numpy
NHWC samples with boxes padded to a static cap.

BDD caches hold an `image_path` decoded with PIL (imported only there) and
scaled to [0,1]; CARLA caches hold the image tensor itself ([3,H,W] or
[H,W,3]), read by torch.load alone.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from automoe_tpu_torch.data.collate import pad_boxes


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
