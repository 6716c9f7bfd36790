"""Ego-frame geometry for CARLA sequence targets (the port's copy of
automoe_tpu/data/ego.py): future world-XY positions are translated to the
ego origin at time t and rotated by -yaw, the vectorised form of the
reference's per-point rotation (dataloaders/carla_sequence_loader.py:18-40).
"""
from __future__ import annotations

import numpy as np


def world_to_ego_xy(points_world_xy: np.ndarray, ego_origin_xy: np.ndarray,
                    ego_yaw_deg: float) -> np.ndarray:
    """[N,2] world points → [N,2] ego frame (x right, y forward)."""
    delta = (np.asarray(points_world_xy, np.float32)
             - np.asarray(ego_origin_xy, np.float32))
    yaw = np.deg2rad(ego_yaw_deg)
    c, s = np.cos(-yaw), np.sin(-yaw)
    rot = np.array([[c, -s], [s, c]], np.float32)
    return delta @ rot.T
