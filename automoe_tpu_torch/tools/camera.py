"""Pinhole camera geometry for the CARLA collector (port of
automoe_tpu/tools/camera.py; pure numpy, vectorised, testable without a
simulator).

Math parity with reference scripts/collect_autopilot_data.py:24-100:
  * intrinsics from width/height/fov;
  * CARLA rotation (pitch/yaw/roll degrees) → R = Yaw(Z)·Pitch(Y)·Roll(X);
  * world→camera extrinsic as the inverse rigid transform;
  * Unreal camera axes (X fwd, Y right, Z up) → standard pinhole
    (x right, y down, z forward) before projection;
  * analytic 2D bbox of a 3D box's 8 vertices, clipped to the image,
    dropping points behind the camera (z ≤ 0.01) and degenerate boxes.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def build_camera_intrinsic(width: int, height: int, fov_deg: float) -> np.ndarray:
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    return np.array(
        [[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]],
        np.float32,
    )


def rotation_matrix(pitch_deg: float, yaw_deg: float, roll_deg: float) -> np.ndarray:
    p, y, r = map(math.radians, (pitch_deg, yaw_deg, roll_deg))
    cy, sy = math.cos(y), math.sin(y)
    cp, sp = math.cos(p), math.sin(p)
    cr, sr = math.cos(r), math.sin(r)
    R_yaw = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
    R_pitch = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float32)
    R_roll = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float32)
    return R_yaw @ R_pitch @ R_roll


def world_to_camera_matrix(
    location_xyz: Sequence[float], rotation_pyr_deg: Sequence[float]
) -> np.ndarray:
    """4x4 world→camera rigid transform from the sensor pose."""
    R_wc = rotation_matrix(*rotation_pyr_deg)
    t_wc = np.asarray(location_xyz, np.float32)
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R_wc.T
    M[:3, 3] = -R_wc.T @ t_wc
    return M


def project_points(K: np.ndarray, points_cam_ue: np.ndarray) -> np.ndarray:
    """[N,3] Unreal-frame camera points → [N,3] (u, v, valid)."""
    Xf, Yr, Zu = points_cam_ue[:, 0], points_cam_ue[:, 1], points_cam_ue[:, 2]
    # Unreal (X fwd, Y right, Z up) → pinhole (x right, y down, z fwd)
    x, y, z = Yr, -Zu, Xf
    valid = z > 0.01
    zs = np.where(valid, z, 1.0)
    u = K[0, 0] * x / zs + K[0, 2]
    v = K[1, 1] * y / zs + K[1, 2]
    return np.stack([u, v, valid.astype(np.float32)], axis=-1)


def compute_2d_bbox(
    world_vertices: np.ndarray,
    K: np.ndarray,
    world_to_cam: np.ndarray,
    width: int,
    height: int,
) -> Optional[List[float]]:
    """[8,3] world-space box corners → clipped [x1,y1,x2,y2] or None."""
    pts_h = np.concatenate(
        [world_vertices, np.ones((len(world_vertices), 1), np.float32)], axis=1
    )
    cam = (world_to_cam @ pts_h.T).T[:, :3]
    uvz = project_points(K, cam)
    vis = uvz[uvz[:, 2] > 0.5]
    if len(vis) == 0:
        return None
    xmin = float(np.clip(vis[:, 0].min(), 0, width - 1))
    ymin = float(np.clip(vis[:, 1].min(), 0, height - 1))
    xmax = float(np.clip(vis[:, 0].max(), 0, width - 1))
    ymax = float(np.clip(vis[:, 1].max(), 0, height - 1))
    if xmax <= xmin or ymax <= ymin:
        return None
    return [xmin, ymin, xmax, ymax]


def box_world_vertices(
    center_xyz: Sequence[float],
    extent_xyz: Sequence[float],
    rotation_pyr_deg: Sequence[float],
) -> np.ndarray:
    """8 world-space corners of an oriented 3D box (CARLA bounding-box
    convention: extent = half sizes)."""
    ex, ey, ez = extent_xyz
    corners = np.array(
        [
            [sx * ex, sy * ey, sz * ez]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ],
        np.float32,
    )
    R = rotation_matrix(*rotation_pyr_deg)
    return corners @ R.T + np.asarray(center_xyz, np.float32)
