"""nuScenes offline preprocessing → per-sample caches (port of
automoe_tpu/tools/preprocess_nuscenes.py).

Parity with reference scripts/preprocess_nuscenes.py:15-90: walk the
official splits via the devkit, and per sample store the CAM_FRONT image
(256x256 + ImageNet norm, CHW float), LIDAR_TOP [N,3], GT boxes, camera
intrinsics, and the sample token. Requires the nuscenes-devkit (not baked
into every environment): the module imports without it, and
`build_cache` raises SystemExit when it is absent; box conversion to plain
arrays (data/datasets.py::boxes_to_arrays) works without it.

    python -m automoe_tpu_torch.tools.preprocess_nuscenes [--version v1.0-mini]
        [--dataroot datasets/nuscenes/raw] [--out_dir datasets/nuscenes/preprocessed]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from automoe_tpu_torch.data.datasets import boxes_to_arrays  # noqa: F401 (re-export)
from automoe_tpu_torch.tools.preprocess_carla import preprocess_image


def preprocess_camera_image(path, out_size: int = 256) -> np.ndarray:
    # shared resize/normalize with the CARLA cache (preprocess_carla.py) —
    # a semantics change there applies to both caches
    return preprocess_image(path, out_size=out_size)


def build_cache(version: str, dataroot: str, out_dir: str, splits=("train", "val")):
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils.splits import create_splits_scenes
    except ImportError as e:
        raise SystemExit(
            "nuscenes-devkit is required for preprocessing (not installed "
            "here). Preprocessed caches from the reference pipeline load "
            "directly via automoe_tpu_torch.data."
        ) from e
    import torch

    nusc = NuScenes(version=version, dataroot=dataroot, verbose=False)
    split_scenes = create_splits_scenes()
    out = Path(out_dir)

    for split in splits:
        scene_names = set(split_scenes[split])
        split_dir = out / split
        split_dir.mkdir(parents=True, exist_ok=True)
        count = 0
        for scene in nusc.scene:
            if scene["name"] not in scene_names:
                continue
            token = scene["first_sample_token"]
            while token:
                sample = nusc.get("sample", token)
                cam = nusc.get("sample_data", sample["data"]["CAM_FRONT"])
                lidar = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
                cs = nusc.get(
                    "calibrated_sensor", cam["calibrated_sensor_token"]
                )
                img = preprocess_camera_image(Path(dataroot) / cam["filename"])
                pts = np.fromfile(
                    Path(dataroot) / lidar["filename"], np.float32
                ).reshape(-1, 5)[:, :3]
                _, boxes, _ = nusc.get_sample_data(cam["token"])
                torch.save(
                    {
                        "image": torch.from_numpy(img),
                        "lidar": torch.from_numpy(pts),
                        "boxes": boxes,
                        "intrinsics": torch.tensor(
                            cs["camera_intrinsic"], dtype=torch.float32
                        ),
                        "token": sample["token"],
                    },
                    split_dir / f"{count:06d}.pt",
                )
                count += 1
                token = sample["next"]
        print(f"{split}: {count} samples")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--version", default=os.environ.get("NUSC_VERSION", "v1.0-mini"))
    p.add_argument(
        "--dataroot", default=os.environ.get("NUSC_DATAROOT", "datasets/nuscenes/raw")
    )
    p.add_argument("--out_dir", default="datasets/nuscenes/preprocessed")
    args = p.parse_args(argv)
    build_cache(args.version, args.dataroot, args.out_dir)


if __name__ == "__main__":
    main()
