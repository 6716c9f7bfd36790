"""Synthetic caches in the reference's on-disk formats:

* CARLA detection, as the CARLA preprocessor writes it
  (automoe_tpu/tools/preprocess_carla.py): `{split}/run_0/NNNNNN.pt`
  holding `image` [3,S,S] float32 (ImageNet-normalised), pixel-xyxy
  `bboxes` float32 [n,4] and `labels` int64 [n];
* CARLA sequences, the frames `CarlaSequenceDataset` windows:
  `{split}/run_K/NNNNNN.pt` holding `image`, `vehicle_state` {`location`
  [3] m, `rotation` [3] deg (yaw at 1), `speed_kmh`, `control` [throttle,
  steer, brake]}, `context` {`weather` [5], `traffic_density` [3]} and
  `meta`; each run is one drive at 10 Hz with smoothly varying speed and
  heading;
* BDD100K detection: `{split}/NNNNN.pt` holding `image_path` (a PNG under
  imgs/, written with PIL), `bboxes` and `labels`;
* BDD100K segmentation / drivable area: `{split}/NNNNN.pt` holding
  `image_path` and `mask_path` (PNGs under imgs/ and masks/): class IDs
  0..18 with some 255 (ignored) pixels, or a 3-channel drivable mask
  whose channel 0 holds {0, 1, 2};
* CARLA segmentation: `{split}/run_0/NNNNNN.pt` holding `image` and a raw
  simulator ID `mask` [S,S] (IDs 0..22: a background of ID 22, past the
  19 classes, and a road band of ID 7, the drivable ID); `finetune-carla
  --task drivable` reads the same cache;
* nuScenes: `{split}/NNNNN.pt` holding `image` [3,S,S], `lidar` [P,3]
  (P varies around 8192), `intrinsics` [3,3], `boxes` [M,7]
  [cx,cy,cz,w,l,h,yaw], `labels` [M] and a string `token`; most points
  lie inside the boxes, so the set loss can fall.

Scenes are a textured background with class-coloured rectangles (regions
for the masks), so the losses can fall. Everything is drawn from one numpy
generator seeded with `seed` alone, so a seed gives the same cache in
every process.

    python -m automoe_tpu_torch.tools.synth OUT_DIR [--format carla|carla-sequence|bdd|
        bdd-segmentation|bdd-drivable|carla-segmentation|nuscenes]
        [--size 256] [--train 64] [--val 32] [--runs 2]

(--train/--val count frames; carla-sequence splits them over --runs runs.)
`nuscenes_batch` builds one nuScenes batch in memory, as the loader gives
it, for the profiling and card-vs-CPU checks. `synth_raw_carla` writes
collector-output episodes (images, segmentation, annotations, LiDAR,
vehicle_log.json, config.json) for tools/preprocess_carla.py, and
`synth_bdd` the BDD caches of one task with PNG frames (the JAX package's
two writers, which tools/campaign.py starts from).
"""
from __future__ import annotations

import argparse
import json
import zlib
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

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


def synth_carla_sequence(out_root, *, n_per_split: Optional[Dict[str, int]] = None,
                         runs: int = 2, size: int = 256, seed: int = 0) -> Path:
    """Write a CARLA sequence cache under out_root and return out_root:
    each split's frames split evenly over `runs` runs."""
    n_per_split = n_per_split or {"train": 84, "val": 26}
    rng = np.random.default_rng(seed)
    root = Path(out_root)
    for split, n in n_per_split.items():
        for r in range(runs):
            d = root / split / f"run_{r}"
            d.mkdir(parents=True, exist_ok=True)
            xy = rng.uniform(-100, 100, 2)
            yaw, speed = rng.uniform(-180, 180), rng.uniform(0, 40)
            weather = rng.uniform(0, 1, 5).astype(np.float32)
            for i in range(n // runs):
                steer = float(np.clip(rng.normal(0, 0.2), -1, 1))
                throttle = float(rng.uniform(0.2, 0.8))
                brake = float(rng.uniform(0, 1) < 0.1)
                speed = float(np.clip(speed + 3 * throttle - 8 * brake - 1, 0, 60))
                yaw += 10 * steer
                heading = np.deg2rad(yaw)
                xy = xy + speed / 3.6 * 0.1 * np.array([np.cos(heading), np.sin(heading)])
                image, _, _ = scene(rng, size, int(rng.integers(1, 8)), 10)
                torch.save({
                    "image": torch.from_numpy(image),
                    "vehicle_state": {
                        "location": torch.tensor([xy[0], xy[1], 0.0], dtype=torch.float32),
                        "rotation": torch.tensor([0.0, yaw, 0.0], dtype=torch.float32),
                        "speed_kmh": torch.tensor(speed, dtype=torch.float32),
                        "control": torch.tensor([throttle, steer, brake], dtype=torch.float32),
                    },
                    "context": {
                        "weather": torch.from_numpy(weather),
                        "traffic_density": torch.from_numpy(
                            rng.uniform(0, 1, 3).astype(np.float32)),
                    },
                    "meta": {"run_id": f"run_{r}", "frame_id": i},
                }, d / f"{i:06d}.pt")
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


def seg_scene(rng: np.random.Generator, size: int, ids: np.ndarray, n_regions: int,
              road_id: int):
    """(ImageNet-normalised image [3,S,S], mask [S,S] int64): a road band
    of `road_id` at the bottom, a background of ids[0] and `n_regions`
    rectangles of IDs drawn from `ids`, each ID with its own colour."""
    palette = rng.uniform(0, 1, (int(ids.max()) + 1, 3)).astype(np.float32)
    mask = np.full((size, size), ids[0], np.int64)
    mask[size * 2 // 3:] = road_id
    for _ in range(n_regions):
        w, h = (rng.uniform(0.1, 0.4, 2) * size).astype(int) + 1
        x1, y1 = rng.integers(0, size - w + 1), rng.integers(0, size - h + 1)
        mask[y1:y1 + h, x1:x1 + w] = rng.choice(ids)
    img = palette[mask] + rng.normal(0, 0.03, (size, size, 3)).astype(np.float32)
    image = (img - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(image.transpose(2, 0, 1)), mask


def _png(path: Path, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def synth_bdd_segmentation(out_root, *, task: str = "segmentation",
                           n_per_split: Optional[Dict[str, int]] = None, size: int = 256,
                           seed: int = 0) -> Path:
    """Write a BDD-format segmentation (19 classes, 255 on a few rows) or
    drivable ({0,1,2} in channel 0 of an RGB mask) cache under out_root
    and return it."""
    n_per_split = n_per_split or {"train": 64, "val": 32}
    rng = np.random.default_rng(seed)
    root = Path(out_root)
    for d in ("imgs", "masks"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for split, n in n_per_split.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            if task == "segmentation":
                image, mask = seg_scene(rng, size, np.arange(19), 6, road_id=0)
                mask[: size // 16] = 255  # an ignored band
                mask_img = mask.astype(np.uint8)
            else:
                image, mask = seg_scene(rng, size, np.array([0, 2]), 3, road_id=1)
                mask_img = np.stack([mask, (mask * 37) % 256, np.zeros_like(mask)],
                                    -1).astype(np.uint8)
            rgb = (image.transpose(1, 2, 0) * IMAGENET_STD + IMAGENET_MEAN) * 255
            img_png = root / "imgs" / f"{split}_{i:05d}.png"
            mask_png = root / "masks" / f"{split}_{i:05d}.png"
            _png(img_png, np.clip(rgb.round(), 0, 255).astype(np.uint8))
            _png(mask_png, mask_img)
            torch.save({"image_path": str(img_png), "mask_path": str(mask_png)},
                       root / split / f"{i:05d}.pt")
    return root


def synth_carla_segmentation(out_root, *, n_per_split: Optional[Dict[str, int]] = None,
                             size: int = 256, seed: int = 0) -> Path:
    """Write a CARLA-format cache with raw semantic-ID masks (IDs 0..22,
    road ID 7, a background of ID 22, past the 19 classes) under out_root
    and return it."""
    n_per_split = n_per_split or {"train": 64, "val": 32}
    rng = np.random.default_rng(seed)
    root = Path(out_root)
    for split, n in n_per_split.items():
        d = root / split / "run_0"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            image, mask = seg_scene(rng, size, np.roll(np.arange(23), 1), 6, road_id=7)
            torch.save({"image": torch.from_numpy(image), "mask": torch.from_numpy(mask)},
                       d / f"{i:06d}.pt")
    return root


def synth_nuscenes(out_root, *, n_per_split: Optional[Dict[str, int]] = None,
                   size: int = 256, points: int = 8192, max_boxes: int = 30,
                   num_classes: int = 10, seed: int = 0) -> Path:
    """Write a nuScenes-format cache under out_root and return it: each
    sample has 1..max_boxes boxes, about `points` LiDAR points (±25%), two
    thirds of them inside the boxes, the rest on the ground."""
    n_per_split = n_per_split or {"train": 64, "val": 32}
    rng = np.random.default_rng(seed)
    root = Path(out_root)
    intrinsics = np.array([[size, 0, size / 2], [0, size, size / 2], [0, 0, 1]], np.float32)
    for split, n in n_per_split.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            m = int(rng.integers(1, max_boxes + 1))
            image, _, labels = scene(rng, size, m, num_classes)
            centers = np.stack([rng.uniform(-20, 20, m), rng.uniform(0, 40, m),
                                rng.uniform(-1, 1, m)], -1)
            wlh = rng.uniform(0.5, 5, (m, 3))
            yaw = rng.uniform(-np.pi, np.pi, (m, 1))
            boxes = np.concatenate([centers, wlh, yaw], -1).astype(np.float32)
            p = int(points * rng.uniform(0.75, 1.25))
            inside = p * 2 // 3
            which = rng.integers(0, m, inside)
            pts_in = centers[which] + (rng.uniform(-0.5, 0.5, (inside, 3)) * wlh[which])
            ground = np.stack([rng.uniform(-30, 30, p - inside), rng.uniform(-5, 50, p - inside),
                               np.full(p - inside, -1.5)], -1)
            lidar = rng.permutation(np.concatenate([pts_in, ground])).astype(np.float32)
            torch.save({"image": torch.from_numpy(image), "lidar": torch.from_numpy(lidar),
                        "intrinsics": torch.from_numpy(intrinsics),
                        "boxes": torch.from_numpy(boxes), "labels": torch.from_numpy(labels),
                        "token": f"{split}-{i:05d}"}, root / split / f"{i:05d}.pt")
    return root


def nuscenes_batch(rng: np.random.Generator, B: int, *, size: int = 256, points: int = 8192,
                   nbox: int = 48) -> Dict[str, np.ndarray]:
    """One in-memory nuScenes batch as the loader gives it: NHWC images,
    [B,points,3] clouds each with its own scale and offset, [B,nbox,7]
    boxes and labels with one padded slot."""
    lidar = (rng.normal(size=(B, points, 3)) * rng.uniform(0.5, 2, (B, 1, 1))
             + rng.normal(size=(B, 1, 3)))
    labels = rng.integers(0, 10, (B, nbox)).astype(np.int32)
    labels[0, -1] = -1
    return {"image": rng.normal(size=(B, size, size, 3)).astype(np.float32),
            "lidar": lidar.astype(np.float32),
            "boxes": (rng.normal(size=(B, nbox, 7)) * 3).astype(np.float32),
            "labels": labels}


# The two writers the staged program (tools/campaign.py) starts from, with
# the JAX package's scenes: solid class colours on a textured background.

def _rect(rng, H, W, lo=0.1, hi=0.6):
    """Random box [x1,y1,x2,y2] covering lo..hi of each dim."""
    w = int(rng.uniform(lo, hi) * W)
    h = int(rng.uniform(lo, hi) * H)
    x1 = int(rng.uniform(0, W - w))
    y1 = int(rng.uniform(0, H - h))
    return x1, y1, x1 + w, y1 + h


# one distinct RGB per class id (stable signal for the class head)
_PALETTE = np.array(
    [[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
     [220, 40, 220], [40, 220, 220], [240, 140, 20], [140, 20, 240],
     [20, 240, 140], [128, 128, 128], [200, 90, 60], [60, 200, 90],
     [90, 60, 200], [230, 230, 230], [30, 90, 160], [160, 30, 90],
     [90, 160, 30], [10, 10, 10], [180, 180, 60]], np.uint8)


def _scene(rng, H, W, n_boxes, num_classes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A textured background with class-colored filled rectangles.
    Returns (image u8 [H,W,3], bboxes f32 [n,4] xyxy, labels i64 [n])."""
    img = rng.integers(60, 90, (H, W, 3)).astype(np.uint8)
    img += (np.linspace(0, 40, W, dtype=np.uint8)[None, :, None])
    boxes, labels = [], []
    for _ in range(n_boxes):
        x1, y1, x2, y2 = _rect(rng, H, W, 0.1, 0.45)
        c = int(rng.integers(0, num_classes))
        img[y1:y2, x1:x2] = _PALETTE[c % len(_PALETTE)]
        boxes.append([x1, y1, x2, y2])
        labels.append(c)
    b = (np.asarray(boxes, np.float32) if boxes
         else np.zeros((0, 4), np.float32))
    return img, b, np.asarray(labels, np.int64)


def synth_bdd(
    out_root,
    *,
    task: str,
    n_per_split: Dict[str, int] = None,
    size: int = 256,
    num_classes: int = None,
    seed: int = 0,
) -> Path:
    """Write a BDD-format cache for `task` under out_root/<task>/.

    detection → {split}/NNNNN.pt {image_path, bboxes, labels}
    segmentation/drivable → {split}/NNNNN.pt {image_path, mask_path}
    (schemas: data/datasets.py BDD*Dataset; reference
    dataloaders/bdd_*_loader.py). A seed gives the same files in every
    process; they differ from the JAX package's writer, whose generator
    is keyed by python's per-process string hash."""
    from PIL import Image

    n_per_split = n_per_split or {"train": 64, "val": 16}
    num_classes = num_classes or {"detection": 10, "segmentation": 19,
                                  "drivable": 3}[task]
    root = Path(out_root) / task
    imgdir = root / "imgs"
    imgdir.mkdir(parents=True, exist_ok=True)
    maskdir = root / "masks"
    if task != "detection":
        maskdir.mkdir(parents=True, exist_ok=True)
    # a stable digest of the task (the JAX package's hash(task) changes
    # between processes)
    rng = np.random.default_rng((seed, zlib.crc32(task.encode()) & 0xFFFF))
    H = W = size
    for split, n in n_per_split.items():
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            name = f"{split}_{i:05d}"
            if task == "detection":
                img, bboxes, labels = _scene(
                    rng, H, W, int(rng.integers(1, 6)), num_classes
                )
                Image.fromarray(img).save(imgdir / f"{name}.png")
                torch.save(
                    {"image_path": str(imgdir / f"{name}.png"),
                     "bboxes": torch.from_numpy(bboxes),
                     "labels": torch.from_numpy(labels)},
                    d / f"{i:05d}.pt",
                )
            else:
                img, bboxes, labels = _scene(
                    rng, H, W, int(rng.integers(2, 6)), num_classes
                )
                mask = np.zeros((H, W), np.uint8)
                if task == "drivable":
                    # a road wedge (class 1) + alternative lane (class 2)
                    y0 = int(H * rng.uniform(0.4, 0.6))
                    mask[y0:, :] = 1
                    xm = int(W * rng.uniform(0.3, 0.7))
                    mask[y0:, xm:] = 2
                    img[y0:, :xm] = [90, 90, 100]
                    img[y0:, xm:] = [120, 120, 90]
                else:
                    for (x1, y1, x2, y2), c in zip(
                        bboxes.astype(int), labels
                    ):
                        mask[y1:y2, x1:x2] = c % num_classes
                Image.fromarray(img).save(imgdir / f"{name}.png")
                Image.fromarray(mask).save(maskdir / f"{name}.png")
                torch.save(
                    {"image_path": str(imgdir / f"{name}.png"),
                     "mask_path": str(maskdir / f"{name}.png")},
                    d / f"{i:05d}.pt",
                )
    return root


def synth_raw_carla(
    out_dir,
    *,
    runs: Sequence[str] = ("run_001", "run_002"),
    n_frames: int = 24,
    hw: Tuple[int, int] = (600, 800),
    seed: int = 0,
) -> Path:
    """Collector-output-format (S1) episodes with a smooth curved
    trajectory: location follows a sinusoid, yaw its tangent, steer its
    curvature, speed varies — so preprocess_carla's ego-frame waypoints
    and the control targets are non-degenerate. Format mirrors
    tools/collect_carla.py's output (reference inference/run_automoe.py &
    datasets/carla/* layout). Byte for byte the JAX package's files for a
    seed."""
    from PIL import Image

    out = Path(out_dir)
    H, W = hw
    for ri, r in enumerate(runs):
        rng = np.random.default_rng((seed, ri))
        run = out / r
        for sub in ("images/front", "segmentation/front", "annots/front",
                    "lidar"):
            (run / sub).mkdir(parents=True, exist_ok=True)
        amp = rng.uniform(3.0, 8.0)
        wave = rng.uniform(0.05, 0.12)
        frames = []
        for t in range(n_frames):
            fname = f"{t:06d}.png"
            img, bboxes, labels = _scene(rng, H, W, 3, 10)
            Image.fromarray(img).save(run / "images" / "front" / fname)
            seg = np.zeros((H, W), np.uint8)
            seg[int(H * 0.55):, :] = 7  # CARLA road id
            seg[: int(H * 0.3), :] = 11  # sky-ish
            for (x1, y1, x2, y2), c in zip(bboxes.astype(int), labels):
                seg[y1:y2, x1:x2] = 1 + (c % 12)
            Image.fromarray(seg).save(run / "segmentation" / "front" / fname)
            boxes = [
                {"bbox": [float(x1), float(y1), float(x2), float(y2)],
                 "label": "vehicle"}
                for (x1, y1, x2, y2) in bboxes
            ]
            (run / "annots" / "front" / f"{t:06d}.json").write_text(
                json.dumps({"boxes": boxes})
            )
            np.save(run / "lidar" / f"{t:06d}.npy",
                    rng.normal(size=(200, 4)).astype(np.float32))
            # curved path: x advances, y sinusoidal; yaw = path tangent
            x = 2.0 * t
            y = amp * np.sin(wave * x)
            dy_dx = amp * wave * np.cos(wave * x)
            yaw = float(np.degrees(np.arctan2(dy_dx, 1.0)))
            curv = -amp * wave * wave * np.sin(wave * x)
            speed = 18.0 + 8.0 * np.sin(0.2 * t)
            frames.append({
                "frame": t,
                "timestamp": 0.05 * t,
                "image_filename": fname,
                "location": {"x": float(x), "y": float(y), "z": 0.0},
                "rotation": {"pitch": 0.0, "yaw": yaw, "roll": 0.0},
                "velocity": {"x": float(speed / 3.6), "y": 0.0, "z": 0.0},
                "speed_kmh": float(speed),
                "control": {
                    "throttle": float(np.clip(0.4 + 0.2 * np.cos(0.2 * t),
                                              0, 1)),
                    "steer": float(np.clip(2.0 * curv, -1, 1)),
                    "brake": 0.0 if t % 11 else 0.3,
                },
                "traffic_density": {
                    "nearby_vehicles_50m": int(rng.integers(0, 6)),
                    "total_npc_vehicles": 10,
                    "total_npc_walkers": 5,
                },
            })
        (run / "config.json").write_text(json.dumps({
            "run_id": r, "map": "Town01",
            "weather": {"cloudiness": float(rng.uniform(0, 100)),
                        "precipitation": 0.0, "wetness": 0.0,
                        "fog_density": float(rng.uniform(0, 30)),
                        "sun_altitude_angle": 45.0},
        }))
        (run / "vehicle_log.json").write_text(json.dumps(frames))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser("automoe_tpu_torch.tools.synth")
    p.add_argument("out")
    p.add_argument("--format", default="carla",
                   choices=["carla", "carla-sequence", "bdd", "bdd-segmentation",
                            "bdd-drivable", "carla-segmentation", "nuscenes"])
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--train", type=int, default=64)
    p.add_argument("--val", type=int, default=32)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    kw = dict(n_per_split={"train": a.train, "val": a.val}, size=a.size, seed=a.seed)
    if a.format == "carla-sequence":
        synth_carla_sequence(a.out, runs=a.runs, **kw)
    elif a.format == "carla":
        synth_carla_detection(a.out, **kw)
    elif a.format == "bdd":
        synth_bdd_detection(a.out, **kw)
    elif a.format.startswith("bdd-"):
        synth_bdd_segmentation(a.out, task=a.format[4:], **kw)
    elif a.format == "carla-segmentation":
        synth_carla_segmentation(a.out, **kw)
    else:
        synth_nuscenes(a.out, **kw)


if __name__ == "__main__":
    main()
