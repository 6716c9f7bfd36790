"""Kinematic mock simulator for the closed loop without CARLA (port of
automoe_tpu/infer/sim.py, pure numpy).

The same surface the runner needs from a simulator (tick, camera frame,
speed, apply_control) over a bicycle model and a synthetic road view, so
the whole perceive → plan → act loop runs headless. For one seed and one
sequence of controls its frames and states are those of the JAX
package's MockSim, byte for byte.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class VehicleState:
    x: float = 0.0
    y: float = 0.0
    yaw: float = 0.0  # radians
    speed_ms: float = 0.0


class MockSim:
    def __init__(
        self,
        *,
        camera_hw: Tuple[int, int] = (600, 800),
        fixed_dt: float = 0.05,
        wheel_base: float = 2.8,
        max_accel: float = 4.0,
        max_brake: float = 8.0,
        drag: float = 0.1,
        seed: int = 0,
    ):
        self.camera_hw = camera_hw
        self.dt = fixed_dt
        self.wheel_base = wheel_base
        self.max_accel = max_accel
        self.max_brake = max_brake
        self.drag = drag
        self.state = VehicleState()
        self._rng = np.random.default_rng(seed)
        self._control = (0.0, 0.0, 0.0)  # throttle, steer, brake

    def apply_control(self, throttle: float, steer: float, brake: float) -> None:
        self._control = (
            float(np.clip(throttle, 0, 1)),
            float(np.clip(steer, -1, 1)),
            float(np.clip(brake, 0, 1)),
        )

    def tick(self) -> None:
        throttle, steer, brake = self._control
        s = self.state
        accel = throttle * self.max_accel - brake * self.max_brake - self.drag * s.speed_ms
        s.speed_ms = max(0.0, s.speed_ms + accel * self.dt)
        # bicycle model; steer in [-1,1] maps to ±35°
        delta = steer * math.radians(35.0)
        s.yaw += (s.speed_ms / self.wheel_base) * math.tan(delta) * self.dt
        s.x += s.speed_ms * math.cos(s.yaw) * self.dt
        s.y += s.speed_ms * math.sin(s.yaw) * self.dt

    @property
    def speed_kmh(self) -> float:
        return self.state.speed_ms * 3.6

    def camera_frame(self) -> np.ndarray:
        """Synthetic road view: sky/ground split + lane wedge whose offset
        tracks heading, plus seeded noise. [H,W,3] uint8."""
        H, W = self.camera_hw
        frame = np.empty((H, W, 3), np.uint8)
        frame[: H // 2] = (120, 170, 230)  # sky
        frame[H // 2 :] = (90, 90, 95)  # asphalt
        # lane markings drift with yaw
        shift = int(np.clip(math.degrees(self.state.yaw) * 4, -W // 4, W // 4))
        ys = np.arange(H // 2, H)
        half_width = ((ys - H // 2) / (H / 2) * (W // 3)).astype(int)
        center = W // 2 + shift
        for off in (-1, 1):
            xs = np.clip(center + off * half_width, 0, W - 1)
            frame[ys, xs] = (240, 240, 240)
        noise = self._rng.integers(0, 12, frame.shape, dtype=np.uint8)
        return frame + noise
