"""Where one detection train step's time goes on the GPU.

    python -m automoe_tpu_torch.tools.profile_train [--batch 32] [--size 256]
        [--box-cap 48] [--matcher auction_kernel] [--steps 5] [--no-tf32]

Runs the detection workload's train step (ResNet-18 expert, seeded random
weights, AdamW, the JAX CLI's defaults) on one seeded synthetic batch of
CARLA-style scenes held on the card, and prints as JSON lines: the card's
name and power limit, the host-clock step time (synchronised; median),
and from torch.profiler over `--steps` steps the device busy time per step
(sum of GPU activity), the idle share, launches per step, the auction
kernel's device time per step, and the activities that take the most
device time. Convolutions run as PyTorch runs them by default (cuDNN in
TF32) unless --no-tf32 is given.
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
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--box-cap", type=int, default=48)
    p.add_argument("--matcher", default="auction_kernel")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-tf32", action="store_true", help="full f32 convolutions")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from automoe_tpu_torch.data.collate import pad_boxes
    from automoe_tpu_torch.tools.synth import scene
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    images, boxes, labels = [], [], []
    for _ in range(args.batch):
        img, b, lab = scene(rng, args.size, int(rng.integers(1, 21)), 10)
        pb, pl = pad_boxes(b, lab, args.box_cap)
        images.append(img.transpose(1, 2, 0))
        boxes.append(pb)
        labels.append(pl)
    batch = {"image": torch.from_numpy(np.stack(images)).to(dev),
             "bboxes": torch.from_numpy(np.stack(boxes)).to(dev),
             "labels": torch.from_numpy(np.stack(labels)).to(dev)}
    wl = bdd_expert_workload("detection", bbox_loss_weight=1.0, matcher=args.matcher)
    model = wl.init_model(args.seed, dev)
    opt = make_optimizer(model.named_parameters(), learning_rate=2e-4, weight_decay=1e-5,
                         total_steps=1000)
    step = make_train_step(wl.loss_fn)
    for _ in range(3):
        step(model, opt, batch)
    torch.cuda.synchronize()
    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        float(step(model, opt, batch)["loss"])
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            float(step(model, opt, batch)["loss"])
        window_ms = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in gpu) / 1e3 / args.steps
    step_ms = window_ms / args.steps
    k1 = sum(_device_us(e) for e in gpu if "auction_kernel" in e.key) / 1e3 / args.steps
    print(json.dumps({"card": smi, "batch": args.batch, "size": args.size,
                      "box_cap": args.box_cap, "matcher": args.matcher, "steps": args.steps,
                      "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                      "host_step_ms_median": float(np.median(wall)),
                      "profiled_step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
                      "idle_share": 1.0 - busy_ms / step_ms,
                      "launches_per_step": sum(e.count for e in gpu) / args.steps,
                      "auction_kernel_ms_per_step": k1,
                      "samples_per_s_host": args.batch * 1e3 / float(np.median(wall))}))
    for e in sorted(gpu, key=_device_us, reverse=True)[: args.top]:
        print(json.dumps({"name": e.key[:100], "calls_per_step": e.count / args.steps,
                          "device_ms_per_step": _device_us(e) / 1e3 / args.steps}))


if __name__ == "__main__":
    main()
