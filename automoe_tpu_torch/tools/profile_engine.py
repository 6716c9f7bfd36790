"""Where one engine step's time goes on the GPU.

    python -m automoe_tpu_torch.tools.profile_engine [--quantize]
        [--stem-variant fused|pool] [--batch 8] [--steps 5]

Runs the engine at full width (default config, 600x800 uint8 frames →
256x256, seeded random weights and frames) and prints, as JSON lines: the
card's name and power limit, the host-clock step time (upload, step,
fetch; median), and from torch.profiler over `--steps` steps the device
busy time per step (sum of GPU activity), the idle share of the step,
launches per step, and the activities that take the most device time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np


def _device_us(e) -> float:
    v = getattr(e, "self_device_time_total", None)
    return float(v if v is not None else e.self_cuda_time_total)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--stem-variant", default="fused", choices=("fused", "pool"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    engine = InferenceEngine(default_model_config(), quantize=args.quantize,
                             stem_variant=args.stem_variant, device="cuda",
                             seed=args.seed)
    rng = np.random.default_rng(args.seed)
    frames = rng.integers(0, 256, (args.batch, *engine.camera_hw, 3), dtype=np.uint8)
    speeds = rng.uniform(0, 40, args.batch).astype(np.float32)
    for _ in range(3):
        engine.infer_batch(frames, speeds)
    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        engine.infer_batch(frames, speeds)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            engine.infer_batch(frames, speeds)
        window_ms = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in gpu) / 1e3 / args.steps
    step_ms = window_ms / args.steps
    print(json.dumps({"card": smi, "engine": "int8" if args.quantize else "bf16",
                      "stem_variant": args.stem_variant if args.quantize else None,
                      "batch": args.batch, "steps": args.steps,
                      "host_step_ms_median": float(np.median(wall)),
                      "profiled_step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
                      "idle_share": 1.0 - busy_ms / step_ms,
                      "launches_per_step": sum(e.count for e in gpu) / args.steps}))
    for e in sorted(gpu, key=_device_us, reverse=True)[: args.top]:
        print(json.dumps({"name": e.key[:100], "calls_per_step": e.count / args.steps,
                          "device_ms_per_step": _device_us(e) / 1e3 / args.steps}))


if __name__ == "__main__":
    main()
