"""BDD100K offline preprocessing → per-image caches (port of
automoe_tpu/tools/preprocess_bdd100k.py).

Behavioral parity with reference scripts/preprocess_bdd100k.py:
  * detection: Scalabel det JSON → per-image {image_path, bboxes xyxy,
    labels} with the 10-class map (:7-18); images with zero parseable
    boxes are skipped (:49-50); scene/timeofday/weather metadata kept.
  * segmentation/drivable: mask directory walk → {image_path, mask_path}
    index caches (:66-82).

Caches are written with torch.save in the reference schema, which the
port's loaders (data/datasets.py) read.

    python -m automoe_tpu_torch.tools.preprocess_bdd100k --task detection|drivable|segmentation
        [--raw_dir datasets/bdd100k/raw] [--out_dir datasets/bdd100k/preprocessed]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

CATEGORY_TO_ID = {
    "person": 0, "rider": 1, "car": 2, "truck": 3, "bus": 4, "train": 5,
    "motorcycle": 6, "bicycle": 7, "traffic light": 8, "traffic sign": 9,
}


def parse_label(label: dict):
    if "box2d" not in label or label.get("category") not in CATEGORY_TO_ID:
        return None
    b = label["box2d"]
    return [b["x1"], b["y1"], b["x2"], b["y2"]], CATEGORY_TO_ID[label["category"]]


def process_detection(json_path, image_root, save_dir) -> int:
    import torch

    annotations = json.loads(Path(json_path).read_text())
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for item in annotations:
        bboxes, labels = [], []
        for label in item.get("labels", []):
            parsed = parse_label(label)
            if parsed:
                bboxes.append(parsed[0])
                labels.append(parsed[1])
        if not bboxes:
            continue
        attrs = item.get("attributes", {})
        sample = {
            "image_path": str(Path(image_root) / item["name"]),
            "bboxes": torch.tensor(bboxes, dtype=torch.float32),
            "labels": torch.tensor(labels, dtype=torch.long),
            "meta": {
                "scene": attrs.get("scene", ""),
                "timeofday": attrs.get("timeofday", ""),
                "weather": attrs.get("weather", ""),
            },
        }
        torch.save(sample, save_dir / (Path(item["name"]).stem + ".pt"))
        n += 1
    return n


def process_segmentation(image_dir, mask_dir, save_dir) -> int:
    import torch

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for mask_path in sorted(Path(mask_dir).glob("*.png")):
        sample = {
            "image_path": str(Path(image_dir) / (mask_path.stem + ".jpg")),
            "mask_path": str(mask_path),
        }
        torch.save(sample, save_dir / (mask_path.stem + ".pt"))
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True,
                   choices=["detection", "drivable", "segmentation"])
    p.add_argument("--raw_dir", default="datasets/bdd100k/raw")
    p.add_argument("--out_dir", default="datasets/bdd100k/preprocessed")
    args = p.parse_args(argv)

    raw, out = Path(args.raw_dir), Path(args.out_dir) / args.task
    image_root = raw / "images" / ("10k" if args.task == "segmentation" else "100k")
    if args.task == "detection":
        labels = raw / "labels" / "detection2020"
        for split, jf in (("train", "det_train.json"), ("val", "det_val.json")):
            n = process_detection(labels / jf, image_root / split, out / split)
            print(f"{split}: {n} samples")
    else:
        label_dir = raw / "labels" / args.task
        for split in ("train", "val"):
            n = process_segmentation(
                image_root / split, label_dir / split, out / split
            )
            print(f"{split}: {n} samples")


if __name__ == "__main__":
    main()
