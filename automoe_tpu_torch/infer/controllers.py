"""Host-side vehicle controllers (pure numpy — these run between sim RPC
and the engine step, parity with reference inference/run_automoe.py:
PID :56-74, pure-pursuit :77-89, finite sanitization :101-108)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


class PID:
    def __init__(
        self, kp: float, ki: float, kd: float,
        clamp: Tuple[float, float] = (0.0, 1.0),
    ):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.clamp_min, self.clamp_max = clamp
        self.integral = 0.0
        self.prev_err: Optional[float] = None

    def reset(self) -> None:
        self.integral = 0.0
        self.prev_err = None

    def step(self, err: float, dt: float) -> float:
        self.integral += err * dt
        deriv = 0.0 if self.prev_err is None else (err - self.prev_err) / max(dt, 1e-3)
        self.prev_err = err
        out = self.kp * err + self.ki * self.integral + self.kd * deriv
        return float(np.clip(out, self.clamp_min, self.clamp_max))


def pure_pursuit_steer(
    waypoints_xy: np.ndarray,
    lookahead_m: float = 3.0,
    wheel_base_m: float = 2.8,
) -> float:
    """Ego-frame waypoints [H,2] (x right, y forward) → steer in [-1,1].

    Picks the waypoint closest to the lookahead distance and converts its
    curvature 2x/(x²+y²) through the bicycle model."""
    if waypoints_xy.size == 0:
        return 0.0
    dists = np.linalg.norm(waypoints_xy, axis=1)
    target = waypoints_xy[int(np.argmin(np.abs(dists - lookahead_m)))]
    x, y = float(target[0]), float(target[1])
    if y <= 1e-3:
        return 0.0
    curvature = (2.0 * x) / (y * y + x * x)
    return float(np.clip(math.atan(wheel_base_m * curvature), -1.0, 1.0))


def to_finite_float(value, default: float = 0.0) -> float:
    try:
        f = float(value)
        if math.isfinite(f):
            return f
    except (TypeError, ValueError):
        pass
    return float(default)


def brake_command(speed_err_kmh: float) -> float:
    """Proportional brake when over target (run_automoe.py:284)."""
    return 0.0 if speed_err_kmh >= 0.0 else min(1.0, -speed_err_kmh / 20.0)
