"""CARLA raw-run preprocessing → per-frame caches + 80/20 run split (port
of automoe_tpu/tools/preprocess_carla.py).

Behavioral parity with reference scripts/preprocess_carla.py:49-297:
  * front image → 256x256 bilinear + ImageNet normalize (stored CHW float
    like the reference caches so both ecosystems read them);
  * raw-ID semantic mask → 256x256 NEAREST;
  * 2D boxes rescaled 800x600→256 with {vehicle:0, pedestrian:1};
  * LiDAR Nx4 → Nx3;
  * intrinsics K_resized = S · K(800,600,fov=90);
  * vehicle_state {location, rotation, velocity, speed_kmh,
    control [throttle, steer, brake]};
  * context {weather 5-d normalized /100 (+sun (a+90)/180),
    traffic_density 3-d};
  * split 80/20 **by run** (:271-273).

The output size is an argument (`out_size`, `--out_size`; default 256)
where the JAX package reads a module global that its campaign patches.

    python -m automoe_tpu_torch.tools.preprocess_carla [--raw_dir datasets/carla/raw]
        [--out_dir datasets/carla/preprocessed] [--val_fraction 0.2] [--out_size 256]
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
RAW_W, RAW_H = 800, 600
OUT_SIZE = 256
CLS_MAP = {"vehicle": 0, "pedestrian": 1}


def build_intrinsics(width: int, height: int, fov_deg: float) -> np.ndarray:
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    return np.array(
        [[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1]], np.float32
    )


def resized_intrinsics(out_size: int = OUT_SIZE) -> np.ndarray:
    sx, sy = out_size / RAW_W, out_size / RAW_H
    S = np.diag([sx, sy, 1.0]).astype(np.float32)
    return S @ build_intrinsics(RAW_W, RAW_H, 90)


def normalize_weather(weather: dict) -> np.ndarray:
    return np.array(
        [
            weather.get("cloudiness", 0.0) / 100.0,
            weather.get("precipitation", 0.0) / 100.0,
            weather.get("wetness", 0.0) / 100.0,
            weather.get("fog_density", 0.0) / 100.0,
            (weather.get("sun_altitude_angle", 0.0) + 90.0) / 180.0,
        ],
        np.float32,
    )


def preprocess_image(path: Path, out_size: int = OUT_SIZE) -> np.ndarray:
    """→ normalized CHW float32 [3,out_size,out_size]. Shared by the CARLA
    and nuScenes caches — one place for resize/normalize semantics."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((out_size, out_size), Image.BILINEAR)
    arr = np.asarray(im, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.transpose(arr, (2, 0, 1))


def process_frame(run_dir: Path, frame_data: dict, config: dict, out_size: int = OUT_SIZE):
    import torch

    image_filename = frame_data["image_filename"]
    stem = Path(image_filename).stem
    img_path = run_dir / "images" / "front" / image_filename
    if not img_path.exists():
        return None
    image = torch.from_numpy(preprocess_image(img_path, out_size))

    mask = None
    seg_path = run_dir / "segmentation" / "front" / image_filename
    if seg_path.exists():
        from PIL import Image

        with Image.open(seg_path) as m:
            m = m.resize((out_size, out_size), Image.NEAREST)
        mask = torch.from_numpy(np.asarray(m).astype(np.int64))

    bboxes = labels = None
    ann_path = run_dir / "annots" / "front" / f"{stem}.json"
    if ann_path.exists():
        ann = json.loads(ann_path.read_text())
        sx, sy = out_size / RAW_W, out_size / RAW_H
        boxes, labs = [], []
        for obj in ann.get("boxes", []):
            bbox, name = obj.get("bbox"), obj.get("label", "vehicle")
            if not bbox or name not in CLS_MAP:
                continue
            x1, y1, x2, y2 = bbox
            boxes.append([x1 * sx, y1 * sy, x2 * sx, y2 * sy])
            labs.append(CLS_MAP[name])
        bboxes = torch.tensor(
            boxes if boxes else np.zeros((0, 4)), dtype=torch.float32
        )
        labels = torch.tensor(labs, dtype=torch.int64)

    lidar = None
    lidar_path = run_dir / "lidar" / f"{stem}.npy"
    if lidar_path.exists():
        pts = np.load(lidar_path)
        if pts.ndim == 2 and pts.shape[1] >= 3:
            lidar = torch.from_numpy(pts[:, :3].astype(np.float32))

    loc, rot = frame_data["location"], frame_data["rotation"]
    vel, ctrl = frame_data["velocity"], frame_data["control"]
    traffic = frame_data["traffic_density"]

    return {
        "image": image,
        "mask": mask,
        "bboxes": bboxes,
        "labels": labels,
        "lidar": lidar,
        "intrinsics": torch.from_numpy(resized_intrinsics(out_size)),
        "vehicle_state": {
            "location": torch.tensor(
                [loc["x"], loc["y"], loc["z"]], dtype=torch.float32
            ),
            "rotation": torch.tensor(
                [rot["pitch"], rot["yaw"], rot["roll"]], dtype=torch.float32
            ),
            "velocity": torch.tensor(
                [vel["x"], vel["y"], vel["z"]], dtype=torch.float32
            ),
            "speed_kmh": torch.tensor(frame_data["speed_kmh"], dtype=torch.float32),
            "control": torch.tensor(
                [ctrl["throttle"], ctrl["steer"], ctrl["brake"]],
                dtype=torch.float32,
            ),
        },
        "context": {
            "weather": torch.from_numpy(normalize_weather(config.get("weather", {}))),
            "traffic_density": torch.tensor(
                [
                    traffic["nearby_vehicles_50m"],
                    traffic["total_npc_vehicles"],
                    traffic["total_npc_walkers"],
                ],
                dtype=torch.float32,
            ),
        },
        "meta": {
            "frame_id": frame_data["frame"],
            "timestamp": frame_data.get("timestamp", 0.0),
            "run_id": config.get("run_id", run_dir.name),
            "map": config.get("map", ""),
            "camera": "front",
            "image_path": str(img_path),
        },
    }


def process_run(run_dir: Path, out_dir: Path, out_size: int = OUT_SIZE) -> int:
    import torch

    config_path = run_dir / "config.json"
    log_path = run_dir / "vehicle_log.json"
    if not config_path.exists() or not log_path.exists():
        print(f"skip {run_dir.name}: missing config/vehicle_log")
        return 0
    config = json.loads(config_path.read_text())
    frames = json.loads(log_path.read_text())
    out = out_dir / run_dir.name
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for frame_data in frames:
        sample = process_frame(run_dir, frame_data, config, out_size)
        if sample is not None:
            torch.save(sample, out / f"{frame_data['frame']:06d}.pt")
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--raw_dir", default="datasets/carla/raw")
    p.add_argument("--out_dir", default="datasets/carla/preprocessed")
    p.add_argument("--val_fraction", type=float, default=0.2)
    p.add_argument("--out_size", type=int, default=OUT_SIZE,
                   help="side of the square frames and masks the caches hold")
    args = p.parse_args(argv)

    runs = sorted(
        d for d in Path(args.raw_dir).iterdir()
        if d.is_dir() and d.name.startswith("run_")
    )
    n_val = max(1, int(len(runs) * args.val_fraction)) if len(runs) > 1 else 0
    train_runs, val_runs = runs[: len(runs) - n_val], runs[len(runs) - n_val :]
    out = Path(args.out_dir)
    for split, split_runs in (("train", train_runs), ("val", val_runs)):
        for run in split_runs:
            n = process_run(run, out / split, args.out_size)
            print(f"{split}/{run.name}: {n} frames")


if __name__ == "__main__":
    main()
