"""Where one train step's time goes on the GPU.

    python -m automoe_tpu_torch.tools.profile_train
        [--workload detection|gating|nuscenes|segmentation|drivable]
        [--batch 32|8|16] [--size 256] [--box-cap 48] [--points 8192]
        [--matcher auction_kernel] [--steps 5] [--no-tf32]
        [--bf16] [--remat] [--qat] [--cache-expert-features]
        [--data-root CACHE | --packed-root PACKED] [--num-workers 4]

Runs a workload's train step with seeded random weights and AdamW at the
JAX CLI's defaults: `detection`, the ResNet-18 expert on one seeded
synthetic batch of CARLA-style scenes (batch 32); `gating`, the default
4-expert AutoMoE with frozen experts on scenes with seeded speeds,
controls and waypoints (batch 8); `nuscenes`, the LiDAR expert with both
TNets and concat fusion, 100 queries, on seeded images, `--points`-point
clouds and `--box-cap` 7-dim boxes (batch 32); `segmentation`, the
19-class BDD expert on seeded region scenes and their masks (batch 32);
`drivable`, the 3-class expert on such scenes (batch 16). The batch is
held on the card, unless `--data-root` names a cache (segmentation: the
`bdd-segmentation` format; drivable: `carla-segmentation`): then every
step takes the next batch of the training CLI's loader (its factory,
`--num-workers` threads, epochs reshuffled), copied to the card as the
train loop copies it; `--packed-root` names a packed cache of the same
data instead (`automoe-pack-torch bdd-segmentation|carla-drivable`), read
a whole batch at a time by the native reader. Prints as JSON lines: the card's name and
power limit, the host-clock step time (synchronised; median; with a
loader it includes the wait for the batch), the wait for the loader's
batch (median), the step's stream time (CUDA events around the step,
as the train loop's timer; median), the peak memory of the warm-up
steps, and from torch.profiler over `--steps` steps the device busy time
per step (sum of GPU activity), the idle share, launches per step, the
auction kernel's device time per step, and the activities that take the
most device time. Convolutions run as PyTorch runs them by default
(cuDNN in TF32) unless --no-tf32 is given. --bf16, --remat and --qat are
the training CLI's step options (bf16 autocast; checkpointed ResNet-18
blocks; int8 fake-quant), for the workloads that take them (gating: --bf16
only). --cache-expert-features profiles the gating trainer's cached step
(train/feature_cache.py): the batch carries its experts' pooled features,
computed once before the timed steps, and the four trunks do not run.
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
    p.add_argument("--workload", default="detection",
                   choices=["detection", "gating", "nuscenes", "segmentation", "drivable"])
    p.add_argument("--batch", type=int, default=None,
                   help="default 32, gating 8, drivable 16")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--box-cap", type=int, default=48)
    p.add_argument("--points", type=int, default=8192, help="nuscenes: LiDAR points a cloud")
    p.add_argument("--matcher", default="auction_kernel")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-tf32", action="store_true", help="full f32 convolutions")
    p.add_argument("--data-root", default=None,
                   help="segmentation|drivable: feed the steps from the CLI's loader")
    p.add_argument("--packed-root", default=None,
                   help="segmentation|drivable: feed the steps from the CLI's loader over "
                        "this packed cache (<root>/train)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--bf16", action="store_true", help="bf16 autocast forward")
    p.add_argument("--remat", action="store_true", help="checkpoint each ResNet-18 block")
    p.add_argument("--qat", action="store_true", help="int8 fake-quant of the trunk")
    p.add_argument("--cache-expert-features", action="store_true",
                   help="gating: the cached step (pooled expert features in the batch)")
    args = p.parse_args(argv)
    fed = args.data_root or args.packed_root
    if fed and args.workload not in ("segmentation", "drivable"):
        p.error("--data-root / --packed-root feed the segmentation and drivable workloads only")
    if args.data_root and args.packed_root:
        p.error("--data-root and --packed-root are exclusive")
    if args.cache_expert_features and args.workload != "gating":
        p.error("--cache-expert-features is the gating workload's")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from automoe_tpu_torch.data.collate import pad_boxes
    from automoe_tpu_torch.tools.synth import nuscenes_batch, scene, seg_scene
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import (bdd_expert_workload, gating_workload,
                                                   nuscenes_workload)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gating = args.workload == "gating"
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    opts = dict(dtype=dtype, remat=args.remat, qat=args.qat)
    args.batch = args.batch or {"gating": 8, "drivable": 16}.get(args.workload, 32)
    rng = np.random.default_rng(args.seed)
    if args.workload == "nuscenes":
        batch = nuscenes_batch(rng, args.batch, size=args.size, points=args.points,
                               nbox=args.box_cap)
        wl = nuscenes_workload(num_queries=100, use_lidar=True, use_tnet=True,
                               fusion="concat", matcher=args.matcher, **opts)
        lr, wd = 1e-4, 1e-5
    elif args.workload in ("segmentation", "drivable"):
        C = 19 if args.workload == "segmentation" else 3
        scenes = [seg_scene(rng, args.size, np.arange(C), 6, road_id=0 if C == 19 else 1)
                  for _ in range(args.batch)]
        batch = {"image": np.stack([im.transpose(1, 2, 0) for im, _ in scenes]),
                 "mask": np.stack([m for _, m in scenes]).astype(np.int32)}
        wl = bdd_expert_workload(args.workload, **opts)
        lr, wd = 1e-4, 1e-5
    else:
        images, boxes, labels = [], [], []
        for _ in range(args.batch):
            img, b, lab = scene(rng, args.size, int(rng.integers(1, 21)), 10)
            pb, pl = pad_boxes(b, lab, args.box_cap)
            images.append(img.transpose(1, 2, 0))
            boxes.append(pb)
            labels.append(pl)
        batch = {"image": np.stack(images)}
        if gating:
            from automoe_tpu_torch.configs import default_model_config

            cfg = default_model_config()
            H = cfg.policy.num_waypoints
            batch.update(speed=rng.uniform(0, 40, (args.batch, H)),
                         steering=rng.normal(0, 0.2, (args.batch, H)),
                         throttle=rng.uniform(0, 1, (args.batch, H)),
                         brake=(rng.uniform(0, 1, (args.batch, H)) < 0.1) * 1.0,
                         waypoints=rng.normal(0, 5, (args.batch, H, 2)))
            wl = gating_workload(cfg, dtype=dtype, cache_features=args.cache_expert_features)
            lr, wd = 1e-4, 1e-4
        else:
            batch.update(bboxes=np.stack(boxes), labels=np.stack(labels))
            wl = bdd_expert_workload("detection", bbox_loss_weight=1.0, matcher=args.matcher,
                                     **opts)
            lr, wd = 2e-4, 1e-5
    batch = {k: torch.from_numpy(v if v.dtype != np.float64 else v.astype(np.float32)).to(dev)
             for k, v in batch.items()}
    batches = _loader_batches(args, dev) if fed else None
    model = wl.init_model(args.seed, dev)
    if args.cache_expert_features:
        from automoe_tpu_torch.models import automoe_pooled_features
        from automoe_tpu_torch.train.feature_cache import pooled_keys

        batch.update(zip(pooled_keys(len(model.experts)), automoe_pooled_features(model, batch)))
    opt = make_optimizer(model.named_parameters(), learning_rate=lr, weight_decay=wd,
                         total_steps=1000, trainable_mask=wl.trainable_mask(model))
    step = make_train_step(wl.loss_fn)
    waits, streams = [], []

    def one_step(record: bool) -> None:
        t0 = time.perf_counter()
        b = next(batches) if batches is not None else batch
        wait = (time.perf_counter() - t0) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        loss = step(model, opt, b)["loss"]
        ev[1].record()
        float(loss)
        if record:
            waits.append(wait)
            streams.append(ev[0].elapsed_time(ev[1]))

    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        one_step(False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        one_step(True)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step(False)
        window_ms = (time.perf_counter() - t0) * 1e3
    gpu = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy_ms = sum(_device_us(e) for e in gpu) / 1e3 / args.steps
    step_ms = window_ms / args.steps
    k1 = sum(_device_us(e) for e in gpu if "auction_kernel" in e.key) / 1e3 / args.steps
    print(json.dumps({"card": smi, "workload": args.workload, "batch": args.batch,
                      "size": args.size, "box_cap": args.box_cap, "matcher": args.matcher,
                      "steps": args.steps,
                      "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                      "bf16": args.bf16, "remat": args.remat, "qat": args.qat,
                      "cache_expert_features": args.cache_expert_features,
                      "data_root": args.data_root, "packed_root": args.packed_root,
                      "num_workers": args.num_workers if fed else None,
                      "host_step_ms_median": float(np.median(wall)),
                      "loader_wait_ms_median": float(np.median(waits)),
                      "step_stream_ms_median": float(np.median(streams)),
                      "profiled_step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
                      "idle_share": 1.0 - busy_ms / step_ms,
                      "launches_per_step": sum(e.count for e in gpu) / args.steps,
                      "auction_kernel_ms_per_step": k1, "peak_memory_bytes": peak,
                      "samples_per_s_host": args.batch * 1e3 / float(np.median(wall))}))
    for e in sorted(gpu, key=_device_us, reverse=True)[: args.top]:
        print(json.dumps({"name": e.key[:100], "calls_per_step": e.count / args.steps,
                          "device_ms_per_step": _device_us(e) / 1e3 / args.steps}))
    if batches is not None:
        batches.close()  # stops the loader's producer thread


def _loader_batches(args, dev):
    """The training CLI's loader over `args.data_root` (or the packed cache
    `args.packed_root`), epoch after epoch, each batch copied to the card as
    the train loop copies it."""
    import torch

    from automoe_tpu_torch.data import factories

    make = (factories.get_bdd_segmentation_loader if args.workload == "segmentation"
            else factories.get_carla_drivable_loader)
    src = ({"packed_root": args.packed_root} if args.packed_root
           else {"root_dir": args.data_root})
    loader = make("train", batch_size=args.batch, num_workers=args.num_workers,
                  seed=args.seed, **src)
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        for b in loader:
            yield {k: torch.as_tensor(v).pin_memory().to(dev, non_blocking=True)
                   for k, v in b.items() if not isinstance(v, list) and k != "_real_count"}
        epoch += 1


if __name__ == "__main__":
    main()
