"""`automoe-pack-torch`: build packed columnar caches from reference-format
preprocessed datasets (port of automoe_tpu/data/pack_cli.py).

Packing pays each sample's decode once and stores one memory-mapped .npy
per field (images float16, labels and masks int32); training then reads
whole batches through the native gather (csrc/packed_reader.cpp). Point
`automoe-train-torch` at the result with `--packed-root`. The caches are
byte-identical to the JAX package's `automoe-pack` for the same data.

Usage:
  python -m automoe_tpu_torch.data.pack_cli bdd-detection \\
      --root datasets/bdd100k/preprocessed/detection --out packed/detection
  python -m automoe_tpu_torch.data.pack_cli carla-sequences \\
      --root datasets/carla/preprocessed --out packed/carla_seq --horizon 8
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

TASKS = ("bdd-detection", "bdd-segmentation", "bdd-drivable", "nuscenes", "carla-detection",
         "carla-segmentation", "carla-drivable", "carla-sequences")


def _frame_dataset(task: str, split_dir: Path, args):
    from automoe_tpu_torch.data import datasets as D

    if task == "bdd-detection":
        return D.BDDDetectionDataset(split_dir, box_cap=args.box_cap)
    if task == "bdd-segmentation":
        return D.BDDSegmentationDataset(split_dir, raw_root=args.raw_root)
    if task == "bdd-drivable":
        return D.BDDDrivableDataset(split_dir, raw_root=args.raw_root)
    if task == "nuscenes":
        return D.NuScenesDataset(split_dir, lidar_cap=args.lidar_cap, box_cap=args.box_cap)
    if task == "carla-detection":
        return D.CarlaDetectionDataset(split_dir, box_cap=args.box_cap)
    if task == "carla-segmentation":
        return D.CarlaSegmentationDataset(split_dir)
    if task == "carla-drivable":
        return D.CarlaDrivableDataset(split_dir)
    raise ValueError(task)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, int]:
    p = argparse.ArgumentParser("automoe-pack-torch", description=__doc__.splitlines()[0])
    p.add_argument("task", choices=TASKS)
    p.add_argument("--root", required=True,
                   help="preprocessed dataset root containing split dirs")
    p.add_argument("--out", required=True,
                   help="output root; one packed cache per split is written to <out>/<split>")
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--box-cap", type=int, default=48)
    p.add_argument("--lidar-cap", type=int, default=8192)
    p.add_argument("--raw-root", default=None,
                   help="raw image root for BDD seg/drivable path resolution")
    p.add_argument("--horizon", type=int, default=8, help="carla-sequences window length")
    p.add_argument("--stride", type=int, default=1)
    args = p.parse_args(argv)

    from automoe_tpu_torch.data.packed import pack_carla_sequences, pack_frames

    counts = {}
    for split in args.splits:
        split_dir = Path(args.root) / split
        out_dir = Path(args.out) / split
        if args.task == "carla-sequences":
            n = pack_carla_sequences(split_dir, out_dir, horizon=args.horizon,
                                     stride=args.stride)
        else:
            n = pack_frames(_frame_dataset(args.task, split_dir, args), out_dir)
        counts[split] = n
        print(f"packed {split}: {n} samples -> {out_dir}", flush=True)
    return counts


if __name__ == "__main__":
    main()
