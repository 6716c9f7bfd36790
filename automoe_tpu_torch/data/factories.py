"""Loader factories (port of automoe_tpu/data/factories.py without the
packed caches): the reference's defaults (batch 32, 4 workers, shuffle
and drop_last on the train split only)."""
from __future__ import annotations

from pathlib import Path

from automoe_tpu_torch.data.datasets import (
    BDDDetectionDataset,
    BDDDrivableDataset,
    BDDSegmentationDataset,
    CarlaDetectionDataset,
    CarlaDrivableDataset,
    CarlaSegmentationDataset,
    CarlaSequenceDataset,
    NuScenesDataset,
)
from automoe_tpu_torch.data.loader import DataLoader

BDD_DETECTION_ROOT = "datasets/bdd100k/preprocessed/detection"
BDD_SEGMENTATION_ROOT = "datasets/bdd100k/preprocessed/segmentation"
BDD_DRIVABLE_ROOT = "datasets/bdd100k/preprocessed/drivable"
NUSCENES_ROOT = "datasets/nuscenes/preprocessed"
CARLA_ROOT = "datasets/carla/preprocessed"


def _mk_loader(dataset, split, batch_size, num_workers, shuffle, **kw):
    if shuffle is None:
        shuffle = split == "train"
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=num_workers, drop_last=(split == "train"), **kw)


def get_bdd_detection_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                             root_dir=BDD_DETECTION_ROOT, box_cap=48, **kw):
    ds = BDDDetectionDataset(Path(root_dir) / split, box_cap=box_cap)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_bdd_segmentation_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                                root_dir=BDD_SEGMENTATION_ROOT, raw_root=None, **kw):
    ds = BDDSegmentationDataset(Path(root_dir) / split, raw_root=raw_root)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_bdd_drivable_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                            root_dir=BDD_DRIVABLE_ROOT, base_dir=None, raw_root=None, **kw):
    root = base_dir if base_dir is not None else root_dir
    ds = BDDDrivableDataset(Path(root) / split, raw_root=raw_root)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_nuscenes_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                        root_dir=NUSCENES_ROOT, lidar_cap=8192, box_cap=64, **kw):
    ds = NuScenesDataset(Path(root_dir) / split, lidar_cap=lidar_cap, box_cap=box_cap)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_detection_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                               root_dir=CARLA_ROOT, box_cap=48, **kw):
    ds = CarlaDetectionDataset(Path(root_dir) / split, box_cap=box_cap)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_sequence_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                              root_dir=CARLA_ROOT, horizon=8, stride=1, include_context=True,
                              **kw):
    ds = CarlaSequenceDataset(Path(root_dir) / split, horizon=horizon, stride=stride,
                              include_context=include_context)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_segmentation_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                                  root_dir=CARLA_ROOT, num_classes=19, **kw):
    ds = CarlaSegmentationDataset(Path(root_dir) / split, num_classes=num_classes)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_drivable_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                              root_dir=CARLA_ROOT, drivable_ids=None, alternative_ids=None,
                              **kw):
    ds = CarlaDrivableDataset(Path(root_dir) / split, drivable_ids=drivable_ids,
                              alternative_ids=alternative_ids)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)
