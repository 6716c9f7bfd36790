"""`automoe-infer-torch`: the closed-loop AutoMoE runner on the PyTorch
port (port of automoe_tpu/infer/run_automoe.py).

Each tick: camera frame → the engine's step on the device → pure-pursuit
steering + PID throttle + proportional brake → the simulator's controls,
with a JSON step log, optional frame dumps and a GIF.

  automoe-infer-torch --backend mock --steps 200            # MockSim, bf16 on cuda
  automoe-infer-torch --backend mock --quantize             # int8 trunks (K3 every step)
  automoe-infer-torch --checkpoint checkpoints/gating/run/best.pt --ema
  automoe-infer-torch --backend carla --town Town05         # a running CARLA server
  automoe-infer-torch --device cpu --backend mock --model-config tiny.json

Backends: CARLA when the `carla` client is importable (`--backend auto`),
otherwise the built-in kinematic MockSim. That picks the simulator, not
the device: the engine runs on `cuda` unless --device names another.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from automoe_tpu_torch.infer.controllers import (
    PID,
    brake_command,
    pure_pursuit_steer,
    to_finite_float,
)
from automoe_tpu_torch.infer.sim import MockSim


def CarlaSim(**kw):  # imported lazily: needs the carla client wheel
    from automoe_tpu_torch.infer.carla_sim import CarlaSim as _C

    return _C(**kw)


def run_closed_loop(
    engine,
    sim,
    *,
    steps: int = 2000,
    fixed_dt: float = 0.05,
    lookahead_m: float = 3.0,
    default_start_kmh: float = 20.0,
    bootstrap_steps: int = 20,
    kp: float = 0.4,
    ki: float = 0.0,
    kd: float = 0.02,
    out_dir: Optional[str] = None,
    save_frames: bool = False,
    record_every: int = 1,
):
    """Drive `sim` with `engine` (anything with `warmup()` and
    `infer(frame, last_speed_kmh)`) for `steps` ticks; returns the step
    logs (also written to `out_dir`/log.json). Defaults are the reference
    loop's: 2000 steps, a 20 km/h start target, 20 bootstrap steps, PID
    0.4 / 0.0 / 0.02."""
    speed_pid = PID(kp=kp, ki=ki, kd=kd)
    logs = []
    frames_dir = None
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        if save_frames:
            frames_dir = out / "frames"
            frames_dir.mkdir(exist_ok=True)

    engine.warmup()
    last_speed_kmh = 0.0
    for step in range(steps):
        sim.tick()
        rgb = sim.camera_frame()

        t0 = time.perf_counter()
        pred = engine.infer(rgb, last_speed_kmh)
        infer_ms = (time.perf_counter() - t0) * 1e3

        waypoints = pred["waypoints"][0]  # [H,2] ego frame
        if waypoints.size == 0 or not np.isfinite(waypoints).all():
            steer = 0.0
        else:
            steer = pure_pursuit_steer(waypoints, lookahead_m=lookahead_m)

        target_kmh = float(pred["speed"].reshape(-1)[-1])
        if not math.isfinite(target_kmh):
            target_kmh = default_start_kmh if step < bootstrap_steps else last_speed_kmh
        curr_kmh = float(sim.speed_kmh)
        last_speed_kmh = curr_kmh

        err_kmh = max(0.0, target_kmh) - curr_kmh
        throttle = speed_pid.step(err_kmh, fixed_dt)
        # stiction bootstrap: a stopped car gets at least 0.3 throttle early on
        if step < bootstrap_steps and curr_kmh < 1.0 and throttle < 0.2:
            throttle = max(throttle, 0.3)
        steer = to_finite_float(steer)
        throttle = to_finite_float(throttle)
        brake = brake_command(err_kmh)
        sim.apply_control(throttle=throttle, steer=steer, brake=brake)

        logs.append(
            {
                "step": step,
                "speed_kmh": curr_kmh,
                "target_kmh": target_kmh,
                "steer": steer,
                "throttle": throttle,
                "brake": brake,
                "infer_ms": infer_ms,
                "expert_weights": pred["expert_weights"][0].tolist(),
            }
        )
        if frames_dir is not None and step % record_every == 0:
            from PIL import Image

            Image.fromarray(rgb).save(frames_dir / f"frame_{step:06d}.jpg", quality=90)

    if out_dir:
        (Path(out_dir) / "log.json").write_text(json.dumps(logs, indent=2))
    return logs


def export_gif(frames_dir: str, gif_path: str, every: int = 1) -> None:
    from PIL import Image

    frames = sorted(Path(frames_dir).glob("frame_*.jpg"))[::every]
    if not frames:
        return
    imgs = [Image.open(f) for f in frames]
    imgs[0].save(gif_path, save_all=True, append_images=imgs[1:], duration=100, loop=0)


def _carla_available() -> bool:
    try:
        import carla  # noqa: F401

        return True
    except ImportError:
        return False


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="Closed-loop AutoMoE on the PyTorch port")
    p.add_argument("--model-config", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="AutoMoE torch checkpoint: a reference .pth or a gating checkpoint "
                        "written by automoe-train-torch")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--fixed-dt", type=float, default=0.05)
    p.add_argument("--lookahead-m", type=float, default=3.0)
    p.add_argument("--default-start-kmh", type=float, default=20.0,
                   help="fallback target speed during bootstrap / when "
                        "the model speed is unavailable")
    p.add_argument("--bootstrap-steps", type=int, default=20)
    p.add_argument("--kp", type=float, default=0.4)
    p.add_argument("--ki", type=float, default=0.0)
    p.add_argument("--kd", type=float, default=0.02)
    p.add_argument("--out-dir", default="infer_out")
    p.add_argument("--save-frames", action="store_true")
    p.add_argument("--record-every", type=int, default=1,
                   help="save every Nth frame (reference --record_every)")
    p.add_argument("--export-gif", action="store_true")
    p.add_argument("--quantize", action="store_true",
                   help="int8 PTQ expert trunks (serving/quant.py)")
    p.add_argument("--ema", action="store_true",
                   help="use the EMA weights of a --ema-decay run's checkpoint")
    p.add_argument("--backend", choices=["auto", "mock", "carla"], default="auto")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=2000)
    p.add_argument("--town", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run without a GPU)")
    args = p.parse_args(argv)

    from automoe_tpu_torch.serving.cli import load_engine

    engine = load_engine(args.model_config, args.checkpoint, args.ema,
                         quantize=args.quantize, device=args.device)
    backend = args.backend
    if backend == "auto":
        backend = "carla" if _carla_available() else "mock"
    if backend == "carla":
        sim = CarlaSim(host=args.host, port=args.port, town=args.town,
                       fixed_dt=args.fixed_dt)
    else:
        sim = MockSim(fixed_dt=args.fixed_dt)

    try:
        logs = run_closed_loop(
            engine,
            sim,
            steps=args.steps,
            fixed_dt=args.fixed_dt,
            lookahead_m=args.lookahead_m,
            default_start_kmh=args.default_start_kmh,
            bootstrap_steps=args.bootstrap_steps,
            kp=args.kp, ki=args.ki, kd=args.kd,
            out_dir=args.out_dir,
            save_frames=args.save_frames or args.export_gif,
            record_every=args.record_every,
        )
    finally:
        if hasattr(sim, "close"):
            sim.close()
    if args.export_gif:
        export_gif(f"{args.out_dir}/frames", f"{args.out_dir}/run.gif")
    lat = [entry["infer_ms"] for entry in logs[5:]]
    summary = {
        "steps": len(logs),
        "final_speed_kmh": logs[-1]["speed_kmh"] if logs else 0,
        "p50_infer_ms": float(np.percentile(lat, 50)) if lat else None,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
