"""Detection loader factories (port of automoe_tpu/data/factories.py):
the reference's defaults (batch 32, 4 workers, shuffle and drop_last on
the train split only)."""
from __future__ import annotations

from pathlib import Path

from automoe_tpu_torch.data.datasets import BDDDetectionDataset, CarlaDetectionDataset
from automoe_tpu_torch.data.loader import DataLoader

BDD_DETECTION_ROOT = "datasets/bdd100k/preprocessed/detection"
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


def get_carla_detection_loader(split="train", batch_size=32, num_workers=4, shuffle=None,
                               root_dir=CARLA_ROOT, box_cap=48, **kw):
    ds = CarlaDetectionDataset(Path(root_dir) / split, box_cap=box_cap)
    return _mk_loader(ds, split, batch_size, num_workers, shuffle, **kw)
