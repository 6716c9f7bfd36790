"""CARLA autopilot data collector (port of automoe_tpu/tools/collect_carla.py).

Structural parity with reference scripts/collect_autopilot_data.py:132-485:
synchronous world at fixed dt, ego with autopilot, 4 RGB cameras + front
semantic camera + LiDAR + collision sensor, NPC traffic and randomized
weather, latest-frame queue draining, every-Nth-frame saving of
PNG/NPY/JSON plus per-frame vehicle state / control / traffic logs,
analytic 2D bbox projection (automoe_tpu_torch.tools.camera), per-run quality
metrics and config dump, and `--continue-from` resume.

Requires the CARLA client + a running server; the geometry and the run
manifest writer below are importable, and `collect_run` runs headless on
any module that offers the client's API (the tests' tests/carla_stub.py).
It draws spawn points, weather and NPC blueprints from python's `random`:
seed it for a repeatable run.

    python -m automoe_tpu_torch.tools.collect_carla [--runs 3] [--duration 600]
        [--vehicles 50] [--walkers 30] [--output datasets/carla/raw] [--save-every 5]
        [--continue-from 1] [--legacy] [--host 127.0.0.1] [--port 2000]

`--legacy` reproduces the superseded RGB-only collector
(reference scripts/collect_autopilot_data_old.py:16-21,190-232): every
camera in the rig saves on each Nth tick, no LiDAR / semantic camera /
bbox annotations, and collision events are logged to collisions.json.
"""
from __future__ import annotations

import argparse
import json
import math
import queue
import random
import time
from pathlib import Path

import numpy as np

from automoe_tpu_torch.tools.camera import (
    build_camera_intrinsic,
    compute_2d_bbox,
    world_to_camera_matrix,
)

CAMERA_RIG = {
    "front": dict(x=1.5, z=1.6, yaw=0.0),
    "left": dict(x=0.5, y=-0.9, z=1.6, yaw=-90.0),
    "right": dict(x=0.5, y=0.9, z=1.6, yaw=90.0),
    "rear": dict(x=-1.8, z=1.6, yaw=180.0),
}
IMG_W, IMG_H, FOV = 800, 600, 90


def drain_latest(q: "queue.Queue"):
    item = None
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return item


def write_run_manifest(run_dir: Path, config: dict, frames: list) -> dict:
    """Persist config.json + vehicle_log.json + quality metrics
    (collect_autopilot_data.py:436-477)."""
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(config, indent=2))
    (run_dir / "vehicle_log.json").write_text(json.dumps(frames, indent=2))
    speeds = [f.get("speed_kmh", 0.0) for f in frames]
    metrics = {
        "n_frames": len(frames),
        "mean_speed_kmh": float(np.mean(speeds)) if speeds else 0.0,
        "max_speed_kmh": float(np.max(speeds)) if speeds else 0.0,
        "stationary_fraction": (
            float(np.mean(np.asarray(speeds) < 0.5)) if speeds else 1.0
        ),
    }
    (run_dir / "quality_metrics.json").write_text(json.dumps(metrics, indent=2))
    return metrics


def collect_run(client, run_idx: int, args) -> dict:
    # runs against a live CARLA server, or headless via tests/carla_stub.py
    import carla

    world = client.get_world()
    settings = world.get_settings()
    settings.synchronous_mode = True
    settings.fixed_delta_seconds = 0.05
    world.apply_settings(settings)

    bp = world.get_blueprint_library()
    spawn_points = world.get_map().get_spawn_points()
    random.shuffle(spawn_points)

    weather_presets = [
        getattr(carla.WeatherParameters, n)
        for n in dir(carla.WeatherParameters)
        if n[0].isupper()
        and isinstance(getattr(carla.WeatherParameters, n), carla.WeatherParameters)
    ]
    weather = random.choice(weather_presets)
    world.set_weather(weather)

    ego = world.spawn_actor(bp.find("vehicle.tesla.model3"), spawn_points[0])
    ego.set_autopilot(True)

    actors, queues = [ego], {}

    def attach_camera(name, cfg, sensor_type="sensor.camera.rgb"):
        cam_bp = bp.find(sensor_type)
        cam_bp.set_attribute("image_size_x", str(IMG_W))
        cam_bp.set_attribute("image_size_y", str(IMG_H))
        cam_bp.set_attribute("fov", str(FOV))
        tf = carla.Transform(
            carla.Location(x=cfg.get("x", 0), y=cfg.get("y", 0), z=cfg.get("z", 1.6)),
            carla.Rotation(yaw=cfg.get("yaw", 0.0)),
        )
        cam = world.spawn_actor(cam_bp, tf, attach_to=ego)
        q: "queue.Queue" = queue.Queue()
        cam.listen(q.put)
        actors.append(cam)
        queues[name] = q

    legacy = getattr(args, "legacy", False)
    for name, cfg in CAMERA_RIG.items():
        attach_camera(name, cfg)

    lidar_q: "queue.Queue" = queue.Queue()
    if not legacy:
        attach_camera("front_seg", CAMERA_RIG["front"],
                      "sensor.camera.semantic_segmentation")
        lidar_bp = bp.find("sensor.lidar.ray_cast")
        lidar_bp.set_attribute("channels", "32")
        lidar = world.spawn_actor(
            lidar_bp, carla.Transform(carla.Location(z=2.4)), attach_to=ego
        )
        lidar.listen(lidar_q.put)
        actors.append(lidar)

    # collision sensor (legacy collisions.json log,
    # collect_autopilot_data_old.py:172-186; S1 logs them too)
    collisions: list = []
    col_sensor = world.spawn_actor(
        bp.find("sensor.other.collision"), carla.Transform(), attach_to=ego
    )
    col_sensor.listen(
        lambda e: collisions.append(
            {"frame": e.frame, "other": e.other_actor.type_id}
        )
    )
    actors.append(col_sensor)

    # NPC traffic — record the ACTUALLY-spawned counts (spawns can fail),
    # like the reference (collect_autopilot_data.py:245-266); the logged
    # traffic_density feeds preprocess_carla's context features
    n_vehicles_spawned = 0
    for sp in spawn_points[1 : 1 + args.vehicles]:
        try:
            npc = world.spawn_actor(
                random.choice(bp.filter("vehicle.*")), sp
            )
            npc.set_autopilot(True)
            actors.append(npc)
            n_vehicles_spawned += 1
        except RuntimeError:
            continue

    # NPC pedestrians at navmesh locations (collect_autopilot_data.py:249-
    # 264) — without them the 'pedestrian' class the CARLA detection
    # fine-tune trains on (preprocess_carla CLS_MAP) never occurs
    n_walkers_spawned = 0
    walker_bps = list(bp.filter("walker.pedestrian.*"))
    for _ in range(args.walkers):
        loc = world.get_random_location_from_navigation()
        if loc is None or not walker_bps:
            continue
        tf = carla.Transform()
        tf.location = loc
        try:
            walker = world.spawn_actor(random.choice(walker_bps), tf)
        except RuntimeError:
            continue
        if walker is not None:
            actors.append(walker)
            n_walkers_spawned += 1

    run_dir = Path(args.output) / f"run_{run_idx:03d}"
    subdirs = (
        tuple(f"images/{c}" for c in CAMERA_RIG)
        if legacy
        else ("images/front", "segmentation/front", "annots/front", "lidar")
    )
    for sub in subdirs:
        (run_dir / sub).mkdir(parents=True, exist_ok=True)

    K = build_camera_intrinsic(IMG_W, IMG_H, FOV)
    frames = []
    n_ticks = int(args.duration / 0.05)
    try:
        for tick in range(n_ticks):
            world.tick()
            if tick % args.save_every:
                continue
            front = drain_latest(queues["front"])
            if front is None:
                continue
            fname = f"{tick:06d}.png"
            front.save_to_disk(str(run_dir / "images/front" / fname))
            if legacy:
                # every-camera RGB saves (collect_autopilot_data_old.py:200-208)
                for cam_name in CAMERA_RIG:
                    if cam_name == "front":
                        continue
                    img = drain_latest(queues[cam_name])
                    if img is not None:
                        img.save_to_disk(
                            str(run_dir / "images" / cam_name / fname)
                        )
            else:
                seg = drain_latest(queues["front_seg"])
                pts = drain_latest(lidar_q)
                if seg is not None:
                    seg.save_to_disk(
                        str(run_dir / "segmentation/front" / fname)
                    )
                if pts is not None:
                    arr = np.frombuffer(pts.raw_data, np.float32).reshape(-1, 4)
                    np.save(run_dir / "lidar" / f"{tick:06d}.npy", arr)

                # analytic 2D boxes for nearby actors
                cam_actor = actors[1]  # front camera
                tf = cam_actor.get_transform()
                w2c = world_to_camera_matrix(
                    [tf.location.x, tf.location.y, tf.location.z],
                    [tf.rotation.pitch, tf.rotation.yaw, tf.rotation.roll],
                )
                boxes = []
                world_actors = world.get_actors()
                annot_actors = list(world_actors.filter("*vehicle*")) + list(
                    world_actors.filter("walker.pedestrian.*")
                )
                for actor in annot_actors:
                    if actor.id == ego.id:
                        continue
                    verts = actor.bounding_box.get_world_vertices(
                        actor.get_transform()
                    )
                    vs = np.array([[v.x, v.y, v.z] for v in verts], np.float32)
                    bb = compute_2d_bbox(vs, K, w2c, IMG_W, IMG_H)
                    if bb:
                        label = (
                            "pedestrian"
                            if "walker.pedestrian" in actor.type_id
                            else "vehicle"
                        )
                        boxes.append({"bbox": bb, "label": label})
                (run_dir / "annots/front" / f"{tick:06d}.json").write_text(
                    json.dumps({"boxes": boxes})
                )

            v = ego.get_velocity()
            loc, rot = ego.get_location(), ego.get_transform().rotation
            ctrl = ego.get_control()
            frames.append(
                {
                    "frame": tick,
                    "timestamp": world.get_snapshot().timestamp.elapsed_seconds,
                    "image_filename": fname,
                    "location": {"x": loc.x, "y": loc.y, "z": loc.z},
                    "rotation": {
                        "pitch": rot.pitch, "yaw": rot.yaw, "roll": rot.roll
                    },
                    "velocity": {"x": v.x, "y": v.y, "z": v.z},
                    "speed_kmh": 3.6 * math.sqrt(v.x**2 + v.y**2 + v.z**2),
                    "control": {
                        "throttle": ctrl.throttle,
                        "steer": ctrl.steer,
                        "brake": ctrl.brake,
                    },
                    "traffic_density": {
                        "nearby_vehicles_50m": sum(
                            1
                            for a in world.get_actors().filter("*vehicle*")
                            if a.id != ego.id
                            and a.get_location().distance(loc) < 50.0
                        ),
                        "total_npc_vehicles": n_vehicles_spawned,
                        "total_npc_walkers": n_walkers_spawned,
                    },
                }
            )
    finally:
        for a in actors[1:]:
            a.destroy()
        ego.destroy()
        settings.synchronous_mode = False
        world.apply_settings(settings)

    (run_dir / "collisions.json").write_text(json.dumps(collisions, indent=2))
    config = {
        "run_id": f"run_{run_idx:03d}",
        "map": world.get_map().name,
        "legacy_rgb_only": legacy,
        "weather": {
            "cloudiness": weather.cloudiness,
            "precipitation": weather.precipitation,
            "wetness": weather.wetness,
            "fog_density": weather.fog_density,
            "sun_altitude_angle": weather.sun_altitude_angle,
        },
    }
    return write_run_manifest(run_dir, config, frames)


def main(argv=None):  # pragma: no cover - needs CARLA
    p = argparse.ArgumentParser(description="CARLA autopilot data collection")
    # defaults = the reference collector's module constants
    # (collect_autopilot_data.py:7-13)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--duration", type=int, default=600)
    p.add_argument("--vehicles", type=int, default=50)
    p.add_argument("--walkers", type=int, default=30)
    p.add_argument("--output", default="datasets/carla/raw")
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--continue-from", type=int, default=1)
    p.add_argument(
        "--legacy", action="store_true",
        help="RGB-only multi-camera collection (reference "
        "scripts/collect_autopilot_data_old.py parity): all rig cameras "
        "saved, no LiDAR/segmentation/bbox annotations",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2000)
    args = p.parse_args(argv)

    try:
        import carla
    except ImportError:
        raise SystemExit("CARLA client not installed; collector requires a sim")

    client = carla.Client(args.host, args.port)
    client.set_timeout(30.0)
    for run_idx in range(args.continue_from, args.runs + 1):
        t0 = time.time()
        metrics = collect_run(client, run_idx, args)
        print(f"run {run_idx}: {metrics} in {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
