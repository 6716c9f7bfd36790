"""CARLA simulator backend for the closed-loop runner (port of
automoe_tpu/infer/carla_sim.py).

The same surface as MockSim (tick / camera_frame / speed_kmh /
apply_control) over a live CARLA server: a synchronous world at a fixed
dt, an ego Tesla Model 3 with a hood RGB camera, the latest frame drained
from the sensor queue, BGRA → RGB, and the world's settings and actors
restored on close. Needs the `carla` client wheel and a running server;
`carla` is imported when a CarlaSim is made, so this module imports
without it.
"""
from __future__ import annotations

import math
import queue
from typing import Optional

import numpy as np


def carla_image_to_rgb(image) -> np.ndarray:
    """CARLA BGRA sensor buffer → contiguous RGB uint8 [H,W,3]."""
    arr = np.frombuffer(image.raw_data, dtype=np.uint8)
    arr = arr.reshape((image.height, image.width, 4))
    return arr[:, :, :3][:, :, ::-1].copy()


class CarlaSim:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 2000,
        town: Optional[str] = None,
        fixed_dt: float = 0.05,
        camera_wh=(800, 600),
        fov: float = 90.0,
    ):
        import carla

        self._carla = carla
        client = carla.Client(host, port)
        client.set_timeout(30.0)
        world = client.get_world()
        if town and world.get_map().name != town:
            world = client.load_world(town)
        self._orig_settings = world.get_settings()
        settings = world.get_settings()
        settings.synchronous_mode = True
        settings.fixed_delta_seconds = fixed_dt
        world.apply_settings(settings)
        self.world = world

        bp = world.get_blueprint_library()
        ego_bp = bp.find("vehicle.tesla.model3")
        ego_bp.set_attribute("role_name", "ego")
        spawn = world.get_map().get_spawn_points()[0]
        self.vehicle = world.spawn_actor(ego_bp, spawn)

        cam_bp = bp.find("sensor.camera.rgb")
        cam_bp.set_attribute("image_size_x", str(camera_wh[0]))
        cam_bp.set_attribute("image_size_y", str(camera_wh[1]))
        cam_bp.set_attribute("fov", str(fov))
        tf = carla.Transform(carla.Location(x=1.5, z=1.6))
        self.camera = world.spawn_actor(cam_bp, tf, attach_to=self.vehicle)
        self._q: "queue.Queue" = queue.Queue()
        self.camera.listen(self._q.put)
        self._latest: Optional[np.ndarray] = None

        # tick until the first frame arrives (at most 20 ticks)
        for _ in range(20):
            world.tick()
            if self._drain() is not None:
                break

    def _drain(self):
        img = None
        while True:
            try:
                img = self._q.get_nowait()
            except queue.Empty:
                break
        if img is not None:
            self._latest = carla_image_to_rgb(img)
        return self._latest

    def tick(self) -> None:
        self.world.tick()
        self._drain()

    def camera_frame(self) -> np.ndarray:
        if self._latest is None:
            h = int(self.camera.attributes["image_size_y"])
            w = int(self.camera.attributes["image_size_x"])
            return np.zeros((h, w, 3), np.uint8)
        return self._latest

    @property
    def speed_kmh(self) -> float:
        v = self.vehicle.get_velocity()
        return 3.6 * math.sqrt(v.x**2 + v.y**2 + v.z**2)

    def apply_control(self, throttle: float, steer: float, brake: float) -> None:
        self.vehicle.apply_control(
            self._carla.VehicleControl(
                throttle=float(np.clip(throttle, 0, 1)),
                steer=float(np.clip(steer, -1, 1)),
                brake=float(np.clip(brake, 0, 1)),
            )
        )

    def close(self) -> None:
        try:
            self.camera.stop()
            self.camera.destroy()
            self.vehicle.destroy()
        finally:
            self.world.apply_settings(self._orig_settings)
