"""Loader factories (port of automoe_tpu/data/factories.py): the
reference's defaults (batch 32, 4 workers, shuffle and drop_last on the
train split only). `packed_root` reads <packed_root>/<split>, a cache that
`automoe-pack-torch` wrote, through the native reader
(data/native_packed.py) instead of the preprocessed dataset."""
from __future__ import annotations

from pathlib import Path
from typing import Optional

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


def _packed_dataset(packed_root, split, expect: Optional[dict] = None):
    """Open <packed_root>/<split> with the native reader. `expect` maps a
    field to the leading row dim the loader was asked for (e.g.
    {'bboxes': 48} for the box cap): the cache keeps the caps it was
    packed with, and a mismatch would otherwise surface as a shape error
    deep in the loss. No fallback: a failed build or open raises."""
    from automoe_tpu_torch.data.native_packed import NativePackedDataset

    d = Path(packed_root) / split
    ds = NativePackedDataset(d)
    for field, want in (expect or {}).items():
        shape = ds.row_shapes.get(field)
        if want is not None and shape and shape[0] != want:
            raise ValueError(f"packed cache {d} was built with {field} leading dim "
                             f"{shape[0]}, but the loader requested {want}: repack with "
                             "automoe-pack-torch or match the CLI flags to the cache")
    return ds


def _mk_loader(dataset, split, batch_size, num_workers, shuffle, **kw):
    if shuffle is None:
        shuffle = split == "train"
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                      num_workers=num_workers, drop_last=(split == "train"), **kw)


def get_bdd_detection_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                             root_dir=BDD_DETECTION_ROOT, box_cap=48, packed_root=None, **kw):
    ds = (_packed_dataset(packed_root, split, expect={"bboxes": box_cap}) if packed_root
          else BDDDetectionDataset(Path(root_dir) / split, box_cap=box_cap))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_bdd_segmentation_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                                root_dir=BDD_SEGMENTATION_ROOT, raw_root=None, packed_root=None,
                                **kw):
    ds = (_packed_dataset(packed_root, split) if packed_root
          else BDDSegmentationDataset(Path(root_dir) / split, raw_root=raw_root))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_bdd_drivable_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                            root_dir=BDD_DRIVABLE_ROOT, base_dir=None, raw_root=None,
                            packed_root=None, **kw):
    root = base_dir if base_dir is not None else root_dir
    ds = (_packed_dataset(packed_root, split) if packed_root
          else BDDDrivableDataset(Path(root) / split, raw_root=raw_root))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_nuscenes_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                        root_dir=NUSCENES_ROOT, lidar_cap=8192, box_cap=64, packed_root=None,
                        **kw):
    ds = (_packed_dataset(packed_root, split, expect={"lidar": lidar_cap, "boxes": box_cap})
          if packed_root else
          NuScenesDataset(Path(root_dir) / split, lidar_cap=lidar_cap, box_cap=box_cap))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_detection_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                               root_dir=CARLA_ROOT, box_cap=48, packed_root=None, **kw):
    ds = (_packed_dataset(packed_root, split, expect={"bboxes": box_cap}) if packed_root
          else CarlaDetectionDataset(Path(root_dir) / split, box_cap=box_cap))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_sequence_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                              root_dir=CARLA_ROOT, horizon=8, stride=1, include_context=True,
                              packed_root=None, **kw):
    # packed: a pack_carla_sequences cache (automoe-pack-torch carla-sequences)
    ds = (_packed_dataset(packed_root, split, expect={"waypoints": horizon}) if packed_root
          else CarlaSequenceDataset(Path(root_dir) / split, horizon=horizon, stride=stride,
                                    include_context=include_context))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_segmentation_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                                  root_dir=CARLA_ROOT, num_classes=19, packed_root=None, **kw):
    ds = (_packed_dataset(packed_root, split) if packed_root
          else CarlaSegmentationDataset(Path(root_dir) / split, num_classes=num_classes))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)


def get_carla_drivable_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                              root_dir=CARLA_ROOT, drivable_ids=None, alternative_ids=None,
                              packed_root=None, **kw):
    ds = (_packed_dataset(packed_root, split) if packed_root
          else CarlaDrivableDataset(Path(root_dir) / split, drivable_ids=drivable_ids,
                                    alternative_ids=alternative_ids))
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)
