"""Synthetic detection caches in the reference's on-disk formats:

* CARLA, as the CARLA preprocessor writes it
  (automoe_tpu/tools/preprocess_carla.py): `{split}/run_0/NNNNNN.pt`
  holding `image` [3,S,S] float32 (ImageNet-normalised), pixel-xyxy
  `bboxes` float32 [n,4] and `labels` int64 [n];
* BDD100K: `{split}/NNNNN.pt` holding `image_path` (a PNG under imgs/,
  written with PIL), `bboxes` and `labels`.

Scenes are a textured background with class-coloured rectangles, so the
detection loss can fall. Everything is drawn from one numpy generator
seeded with `seed` alone, so a seed gives the same cache in every process.

    python -m automoe_tpu_torch.tools.synth OUT_DIR [--format carla|bdd] [--size 256]
        [--train 64] [--val 32]
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def scene(rng: np.random.Generator, size: int, n_boxes: int, num_classes: int):
    img = rng.uniform(0.2, 0.35, (size, size, 3)).astype(np.float32)
    palette = rng.uniform(0, 1, (num_classes, 3)).astype(np.float32)
    boxes = np.zeros((n_boxes, 4), np.float32)
    labels = rng.integers(0, num_classes, n_boxes)
    for k in range(n_boxes):
        w, h = rng.uniform(0.05, 0.4, 2) * size
        x1, y1 = rng.uniform(0, size - w), rng.uniform(0, size - h)
        boxes[k] = (x1, y1, x1 + w, y1 + h)
        img[int(y1):int(y1 + h), int(x1):int(x1 + w)] = palette[labels[k]]
    image = (img - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(image.transpose(2, 0, 1)), boxes, labels.astype(np.int64)


def synth_carla_detection(out_root, *, n_per_split: Optional[Dict[str, int]] = None,
                          size: int = 256, max_boxes: int = 20, num_classes: int = 10,
                          seed: int = 0) -> Path:
    """Write the cache under out_root and return out_root; each frame holds
    1..max_boxes boxes."""
    n_per_split = n_per_split or {"train": 64, "val": 32}
    rng = np.random.default_rng(seed)
    root = Path(out_root)
    for split, n in n_per_split.items():
        d = root / split / "run_0"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            image, boxes, labels = scene(rng, size, int(rng.integers(1, max_boxes + 1)),
                                          num_classes)
            torch.save({"image": torch.from_numpy(image), "bboxes": torch.from_numpy(boxes),
                        "labels": torch.from_numpy(labels)}, d / f"{i:06d}.pt")
    return root


def synth_bdd_detection(out_root, *, n_per_split: Optional[Dict[str, int]] = None,
                        size: int = 256, max_boxes: int = 20, num_classes: int = 10,
                        seed: int = 0) -> Path:
    """Write a BDD-format detection cache under out_root and return it."""
    from PIL import Image

    n_per_split = n_per_split or {"train": 64, "val": 32}
    rng = np.random.default_rng(seed)
    root = Path(out_root)
    (root / "imgs").mkdir(parents=True, exist_ok=True)
    for split, n in n_per_split.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            image, boxes, labels = scene(rng, size, int(rng.integers(1, max_boxes + 1)),
                                          num_classes)
            rgb = (image.transpose(1, 2, 0) * IMAGENET_STD + IMAGENET_MEAN) * 255
            png = root / "imgs" / f"{split}_{i:05d}.png"
            Image.fromarray(np.clip(rgb.round(), 0, 255).astype(np.uint8)).save(png)
            torch.save({"image_path": str(png), "bboxes": torch.from_numpy(boxes),
                        "labels": torch.from_numpy(labels)}, root / split / f"{i:05d}.pt")
    return root


def main(argv=None) -> None:
    p = argparse.ArgumentParser("automoe_tpu_torch.tools.synth")
    p.add_argument("out")
    p.add_argument("--format", choices=["carla", "bdd"], default="carla")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--train", type=int, default=64)
    p.add_argument("--val", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    fn = synth_carla_detection if a.format == "carla" else synth_bdd_detection
    fn(a.out, n_per_split={"train": a.train, "val": a.val}, size=a.size, seed=a.seed)


if __name__ == "__main__":
    main()
