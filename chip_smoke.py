#!/usr/bin/env python3
"""Smoke run of the PyTorch port (automoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (none is caught):
  1. build the CUDA kernels from automoe_tpu_torch/csrc, one nvcc per
     source, and the packed caches' host reader (packed_reader.cpp, g++),
     all started together (stem.cu timed here, auction.cu in 8, the
     reader in 15);
  2. K3, the fused int8 stem kernel, against its plain PyTorch version
     at B=1 and B=2 (the closed loop's batch: most persistent blocks get
     no tile), B=8 and B=128, 256x256 input: int8 outputs within ±1 on at most
     0.1% of elements, with inv > 0 and with inv of both signs; the
     kernel's time alone (back-to-back launches of the library's entry
     point, three blocks of 50) and through its
     wrapper, beside the plain version and the unfused "pool"-variant
     path (serving/quant.py::s2d_stem_pool_unfused: cuDNN conv, quantize,
     K4) at the same shapes; then K3's f32 instantiation (the int8 path
     at --fp32) against its plain version at B=8 and B=32, TF32 off, the
     same tolerance and at most 5e-5 of the elements off (f32's level),
     timed alone, through its wrapper and plain, its bound its three TF32
     tensor-core passes over 495 TFLOP/s (dense TF32);
  3. K4, the int8 3x3/s2 pool kernel, against its plain version at
     [8,128,128,256] and [128,128,128,256]: bit-exact; the kernel's time
     alone (three blocks of 50 back-to-back launches of the library's
     entry point, the median block) and through its wrapper;
  4. the f32 engine on the card against the same engine on the CPU, on a
     small input (TF32 off): rtol 1e-3 / atol 1e-4;
  5. the bf16 engine at full width (default 4-expert config, 600x800
     frames → 256x256) on 8 seeded frames: finite outputs of the right
     shapes, expert weights summing to 1;
  6. the int8 engine (quantize=True, 2 calibration frames) on the same
     frames: K3 launched once per step, waypoints within 3% mean relative
     error of the bf16 engine, expert weights within 0.05; again with the
     "pool" stem variant, which launches K4;
  7. serving: `automoe-serve-torch --quantize` (serving/cli.py) answers 4
     concurrent TCP requests; K3 launches once per server batch.
  8. the auction kernel's build (csrc/auction.cu, timed);
  9. K1+K2, the auction with its in-kernel JV escalation, against its plain
     version at B=32, N=48, Q=64 in three regimes (diverse random costs,
     degenerate clustered predictions, max_iters=0 = every element through
     JV with invalid rows and one invalid element;
     tools/bench_auction.py::auction_regimes): identical assignments,
     total cost within 1e-4 of scipy's linear_sum_assignment (1e-7 of the
     optimum's magnitude where that passes 1e6), and with
     escalate=False (greedy completion) identical to its plain version;
     the kernel's time alone (back-to-back launches of the library's entry
     point on pre-masked inputs, three blocks of 50) and through its
     wrapper;
 10. two SGD detection train steps on the card (matcher auction_kernel:
     K1 launches) against the same steps on the CPU (its plain version),
     f32 with TF32 off, 64x64 images, B=2, N=4, weights from one seed:
     losses within rtol 1e-4, parameters within rtol 1e-3 / atol 1e-5;
 11. the entry point `automoe-train-torch finetune-carla --task detection`
     (train/cli.py) at 256x256, box cap 48, batch 32, 2 epochs on a seeded
     CARLA-format cache of 64 train and 32 val frames, at PyTorch's default
     precision (cuDNN TF32): K1 launches once per train and eval step,
     losses finite, the train step's stream time (CUDA events around each
     step, host launch gaps included); then one epoch of `bdd --task
     detection` on a BDD-format cache;
 12. the pipeline a port-trained expert takes to the server, through the
     entry points, at PyTorch's default precision: `finetune-carla --task
     detection` (256x256, batch 32, box cap 48) for 1 epoch with
     --ckpt-root and --save-freq 1, then `--resume full --resume-from last
     --epochs 2` (K1 launches for epoch 2's steps only; the optimizer step
     count continues); `gating` at the default 4-expert config, 256x256,
     batch 8, 1 epoch on a seeded CARLA sequence cache, with
     `--expert-ckpts <detection best>,,,` (finite losses, expert-0
     parameters equal to the detection checkpoint's, the step's stream
     time, peak memory); `policy` at 256x256, batch 32, 1 epoch; then
     `automoe-serve-torch --checkpoint <gating best> --quantize` answers 4
     TCP requests with K3 launched once per server batch;
 13. the nuScenes, segmentation and drivable paths: K1+K2 against its
     plain version at the nuScenes trainers' shapes
     (tools/bench_auction.py::nuscenes_regimes: B=32, N=48, Q=100 on
     7-dim boxes, cap 128: diverse, degenerate, an untrained head's
     outputs, and negative sizes on both sides with costs ~1e10; B=16,
     N=48, Q=196 with max_iters=0, K2 alone), as phase 9 does; two SGD
     `nuscenes` steps
     (LiDAR, TNets, concat; 64x64, 256 points, B=8, Q=16, N=4, dropout
     off, TF32 off) on the card (K1) against the CPU (plain version), as
     phase 10 does; then, at PyTorch's default precision, through the
     entry point: `nuscenes --use-lidar --use-tnet --fusion concat` at
     256x256, batch 32, LiDAR cap 8192, box cap 48, 100 queries, 2 epochs
     on a seeded cache of 64 train and 32 val samples (K1 once per train
     and val step, finite losses, the step's stream time, peak memory);
     `nuscenes-2d` (196 queries, batch 16, box cap 48, 1 epoch on a CARLA
     detection cache: K2 alone once per step); `bdd --task segmentation`
     (batch 32) and `finetune-carla --task drivable` (batch 16), 1 epoch each on 128 train and 32 val frames: no kernel
     launched, finite losses, pixel_acc and mean_iou in [0, 1]; and
     `automoe-serve-torch --quantize` with the default config's nuScenes
     expert made a LiDAR one (TNets, concat) answers 4 TCP requests, K3
     once per server batch;
 14. the trainer's step options: (a) one `--grad-accum 2` step and one
     `--steps-per-call 2` call of the detection workload with
     `--augment` (parameters drawn on the host from the step's key, so
     the card and the CPU get the same ones) and an EMA, on the card (K1
     once per microbatch and step) against the CPU (plain version), TF32
     off, 64x64, B=2, N=4 as phase 10, without --qat (losses within
     rtol 1e-4, parameters, statistics and EMA within rtol 1e-3 / atol
     1e-5) and with it (the largest loss and state differences within
     10x those between two CPU runs whose images differ by 1e-6: QAT's
     rounding boundaries); then,
     at PyTorch's default precision and the CLI's widths (256x256, batch
     32, box cap 48, Q=64): (b) `bdd --task detection --bf16 --augment
     --qat --remat --ema-decay 0.999 --grad-accum 2 --max-inflight 2
     --profile-dir` for 1 epoch of 192 frames (K1 once per microbatch and
     per raw and EMA val step, the trace file), and again without
     --profile-dir (the call's stream time, samples/s, peak memory); (c) `finetune-carla --task detection
     --steps-per-call 4` on 256 frames (K1 once per step); (d) `bdd --task segmentation
     --augment --bf16`; (e) `gating --expert-ckpts <(b)'s best>,,,
     --ema-decay 0.999`, its EMA of the grafted expert equal to the
     expert (rtol 1e-6), then `automoe-serve-torch --checkpoint <gating
     best> --ema --quantize` answers 4 TCP requests, K3 once per server
     batch;
 15. the fast data paths: (a) the native reader's `read_batch` equals the
     python memmap reader's byte for byte on a packed 256x256 CARLA
     detection cache (each one's host time for 32 frames); (d) one SGD
     step of the cached gating workload equals the experts_eval step from
     the same weights and key (default config, 256x256, B=8, TF32 off;
     loss rtol 1e-5, trained parameters rtol 1e-3 / atol 1e-4, experts
     bit-equal to the start); then at PyTorch's default precision: (b)
     `automoe-pack-torch bdd-detection` packs a 256x256 BDD cache (64
     train, 32 val) and `bdd --task detection` (batch 32, box cap 48) runs
     2 epochs from its PNG frames and 2 from the packed cache: K1 once per
     train and val step in each, finite losses, each one's stream time a
     step; (c) `automoe-pack-torch carla-sequences` (256 train windows)
     and `gating --packed-root --expert-ckpts <phase 12's detection
     best>,,, --cache-expert-features --feature-cache-dir D
     --device-resident --steps-per-call 4 --batch-size 32` for 2 epochs
     (each split's features computed once), then again for 1 epoch (the
     cache loaded from D, nothing computed), each call's stream time
     beside phase 12's plain gating step; (e) `automoe-serve-torch
     --checkpoint <(c)'s best> --quantize` answers 4 TCP requests, K3 once
     per server batch;
 16. the eval CLI, `automoe-eval-torch`, at the CLI's widths (256x256,
     batch 32, box cap 48) on synthetic CARLA frames, each run on the card
     and again with --device cpu (TF32 off), the JSON held card against
     CPU (float: rtol / atol 1e-3; int8: 3% / 0.05, as phase 6): `bdd
     --task detection` on phase 12's detection checkpoint, 64 frames, with
     and without --quantize (K2 alone once per batch), `bdd --task
     drivable` on phase 13's (no kernel), `nuscenes` on phase 13's LiDAR +
     TNet checkpoint (K2 once per batch), `gating --quantize` on phase 12's
     gating checkpoint, 64 windows (K3 f32 once per batch),
     `visualize-detection` (16 overlays, K2 once), `training-curves` on
     phase 12's detection run; then `automoe-serve-torch --quantize
     --fp32` answers 4 TCP requests, K3 f32 once per server batch;
 17. the closed loop, `automoe-infer-torch` (infer/run_automoe.py) on
     MockSim at full width (the default 4-expert config, 600x800 frames →
     256x256): (a) `--steps 200` in bf16 (no kernel launched); (b) the
     same with `--quantize`, K3 launched at B=1 once per control step and
     once for the warm-up (201); (c) `--checkpoint <phase 12's gating
     best> --quantize`, 50 steps (51 launches); (d) `--backend carla` on
     tests/carla_stub.py, 10 steps with --quantize (11); every log's
     controls finite and in range, expert weights summing to 1; (e) a
     12-step f32 closed loop, card against CPU, TF32 off: steer, throttle,
     brake and speed within atol 1e-4, expert weights within 1e-5; (f) the
     engine with context 'full' and top-2 routing honoured at eval
     (apply_topk_at_eval), f32, B=8, card against CPU (rtol 1e-3 / atol
     1e-4, two experts chosen a frame). Each prints its p50 inference time
     (host clock of `engine.infer`) and launches.
 18. export bundles (serving/export.py), the stem kernels as torch.library
     ops inside traced programs, at full width: (a) `save_serving_bundle`
     (buckets 1 and 8) of four engines (bf16; int8, K3; int8 --fp32, K3's
     f32 kernel; int8 with the "pool" stem, K4), each loaded through
     `ArtifactEngine` and held against its live engine on the same frames
     at B=8 and B=1 (f32 engines rtol 1e-5 / atol 1e-6, bf16 ones 1e-2:
     BUNDLE_TOL), its stem kernel launched once per bundle batch; the live
     engine's build, the export, the load, the first batch and each one's
     B=8 step time (host clock), the bundle's size; (b) `automoe-serve-torch
     --bundle <int8>` answers 4 TCP requests (K3 once per server batch) and
     `--bundle --ema` exits non-zero; (c) cold start, each in a fresh
     process: the live int8 engine (calibration included) against its
     bundle, imports and CUDA start-up, build or load, first B=8 batch, the
     bundle's process importing no model code; (d) `FusedAutoMoE` against
     `AutoMoE` on the same fused weights (default config, 256x256, B=8):
     f32 with TF32 off (rtol 1e-4 / atol 1e-5), then bf16 (phase 6's
     bound), each forward's time from CUDA events; (e) the host cost of a
     call through the custom ops against their CUDA bodies called
     directly (K3 bf16 and K4, B=8, host clock, median of 100 calls).
 19. the deep policy (models/deep_policy.py): (a) one AdamW step (depth 4,
     width 32, 64x64, B=4, context 8) on the card against the CPU, TF32
     off: loss within rtol 1e-4, parameters within rtol 1e-3 / atol 1e-5;
     (b) `automoe-train-torch policy --trunk-depth 16 --trunk-width 128`
     at 256x256, B=32, 2 epochs on a seeded CARLA sequence cache, then
     `--resume full` for a third: finite losses, best.pt, the stacked
     trunk in the checkpoint; (c) its train step's time (CUDA events) and
     the trunk's achieved FLOP/s (trunk_flops_per_sample x 3 x B over the
     step) against the dense TF32 peak (the default precision's convs);
     then 2 epochs with --bf16 against the dense bf16 peak.
 20. the staged program (tools/campaign.py) at 256x256 and full width, its
     counts cut (64 BDD frames a task, 3 CARLA runs of 32 frames, one
     epoch a stage, 5 s of serving, 20 closed-loop steps; CAMPAIGN_ARGV),
     with every kernel's count reset just before it: (a-b) all eight
     stages, finite losses, K1 launched in the BDD and CARLA detection
     steps, K2 alone in the nuscenes-2d steps, K3 in the export stage's
     int8 frame, the closed loop finite, the int8-vs-bf16 controls and
     each stage's seconds printed; (c) `automoe-launch-torch policy-gating`
     with SKIP_GATING=1 on its CARLA caches; (d) `automoe-supervise-torch`
     around a trainer that exits non-zero after one of its two epochs,
     relaunched with `--resume full` to the end; (e) `checks cuda`.

 21. the whole-block parallel modes (parallel/), through
     `automoe-train-torch` at the CLI's widths with TF32 off, each rank a
     process of its own with a timeout (a failed or hung rank fails the
     run); first K1+K2 against its plain version at B=16 (the batch of a
     data-parallel rank of 21b), as phase 9 does; (a) `bdd --task
     detection` (256x256, box cap 48, batch 32, 1 epoch of 64 frames)
     with the default mesh (a group of one: no collective), with
     --no-mesh, and as a group of one over NCCL (`--multihost
     --num-processes 1`): K1 once per step in each, step losses and
     parameters held against the default run (losses rtol 1e-4,
     parameters rtol 1e-3 / atol 4·lr·steps, the CPU test's rule for
     AdamW), each one's step time; (b) the same global batch as 2 ranks
     of 16 rows on this card (gloo, host staging), held against (a) by
     the same rule, K1 once per step on each rank, each rank's step time
     (two ranks share the card: no scaling figure); (c) `policy
     --trunk-depth 16 --trunk-width 128 --pp-microbatches 4 --model-axis
     2` (256x256, batch 32, 1 epoch) on 2 ranks against --no-mesh; (d)
     `gating --parallelism ep --model-axis 4` (default config, 256x256,
     batch 8, 1 epoch) on 4 ranks against dense gating in one process,
     then `automoe-serve-torch --checkpoint <its best> --quantize` answers
     4 TCP requests, K3 once per server batch.
 22. the split-tensor modes and the multi-rank pieces (parallel/tp.py,
     parallel/sp.py, the shared feature cache, the resident epoch over
     data ranks, serving replicas), on 21's caches, TF32 off, each run in
     a process of its own reporting its kernel launches and peak device
     memory: (a) `bdd --task detection` (256x256, box cap 48, batch 32,
     1 epoch of 64 frames) with --tp-min-dim 256 --model-axis 2 on 2
     ranks (gloo) against --no-mesh, K1 once per step on each rank, each
     rank's step time and peak memory; with the CLI's AdamW the
     parameters held by 21's rule and BatchNorm's running statistics
     reported (they follow AdamW's noise-moved weights), and again with
     SGD, every tensor held at rtol 1e-4 / atol 1e-5; (b) the same with
     --spatial --model-axis 2 (hand-written halos); (c) `gating
     --cache-expert-features --device-resident --steps-per-call 2`
     (default config, 256x256, 8 rows a rank, 1 epoch) on 2 ranks
     against one process of 16 rows over the same flat epoch, dropout
     off in both: the runs held by 21's rule, the caches' fingerprints
     equal and their arrays within rtol 1e-5, each epoch's exchange
     timed; (d) `automoe-serve-torch --data-parallel --quantize` (one
     replica: this card) answers 4 TCP requests, K3 once per server
     batch, its engine equal to the plain one.
Prints the card's name and power limit, one JSON line of kernel results,
and, last, {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device or outside a checkout of the repository. It needs one card.

    python3 chip_smoke.py --cards

runs only phase 21's and 22's comparisons with one rank a card (NCCL), on a
host of 4 cards (`phase_parallel_cards`, `phase_split_cards`: tensor
parallel at data 2 x model 2 and spatial at model 2 x data 2 against one
process, and --data-parallel serving over 4 replicas with a 3-frame batch
padded to 4, against one card).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
# dense TF32 on the tensor cores: the same data sheet
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
SEED = 0
B_MAIN = 8


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_median(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median over launches, each timed by its own pair of CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, flops_peak: float, nbytes: int):
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def stem_inputs(B: int, gen):
    import torch

    xs = torch.randn(B, 132, 132, 12, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(192, 256, device="cuda", generator=gen) * 0.05).bfloat16()
    bias = torch.randn(256, device="cuda", generator=gen) * 0.1
    inv = 127.0 / (torch.rand(256, device="cuda", generator=gen) * 4 + 1)
    return xs, w, bias, inv


def stem_kernel_ms(stem, xs, w, bias, inv, blocks: int = 3, iters: int = 50,
                   entry: str = "automoe_stem_s2d_pool_int8") -> list:
    """K3 alone: the library's entry point (`entry`: the bf16 kernel, or
    automoe_stem_s2d_pool_int8_f32) launched back to back on pre-built
    inputs (no wrapper checks, no launch count), CUDA events around each
    block of `iters` launches; the mean of each block."""
    import torch

    lib = stem.build()
    B, hp, wp, _ = xs.shape
    O = w.shape[1]
    out = torch.empty((B, *stem.pool_out_hw(hp - 4, wp - 4), O), dtype=torch.int8,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    fn = getattr(lib, entry)

    def launch():
        stem.raise_on(fn(xs.data_ptr(), w.data_ptr(), bias.data_ptr(), inv.data_ptr(),
                         out.data_ptr(), B, hp, wp, O, stream), entry)

    return [cuda_ms(launch, iters=iters) for _ in range(blocks)]


def k3_against_plain(stem, args, gen):
    """K3 (either dtype) on (xs, w, bias, inv) of a 256x256 input, O = 256,
    against its plain version, with inv as given and with inv of both
    signs (about half the channels negative, one zero): int8 outputs within
    ±1 on at most 0.1% of elements. Returns (the output, max error, share
    of elements off, the same two with mixed signs)."""
    import torch

    out = stem.s2d_stem_pool_int8(*args)
    torch.cuda.synchronize()
    d = (out.int() - stem.s2d_stem_pool_int8_plain(*args).int()).abs()
    max_err, frac = int(d.max()), float((d > 0).float().mean())
    assert out.shape == (args[0].shape[0], 64, 64, 256) and out.dtype == torch.int8
    assert max_err <= 1 and frac <= 1e-3, (args[0].dtype, max_err, frac)
    xs, w, bias, inv = args
    sign = torch.where(torch.rand(256, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
    mixed = (xs, w, bias, inv * sign * (torch.arange(256, device="cuda") != 7))
    d = (stem.s2d_stem_pool_int8(*mixed).int()
         - stem.s2d_stem_pool_int8_plain(*mixed).int()).abs()
    torch.cuda.synchronize()
    mixed_err, mixed_frac = int(d.max()), float((d > 0).float().mean())
    assert mixed_err <= 1 and mixed_frac <= 1e-3, (xs.dtype, mixed_err, mixed_frac)
    return out, max_err, frac, mixed_err, mixed_frac


def phase_k3(stem, gen):
    """K3 against its plain version at B=1, 2, 8 and 128: int8 outputs within
    ±1 on at most 0.1% of elements, with inv > 0 and with inv of both
    signs. Times: the kernel alone (three blocks of 50 back-to-back
    launches, the median block), its wrapper (median of 30 calls, one event
    pair each), the plain version (mean of 5) and the unfused
    "pool"-variant path (three blocks of 20, the median block)."""
    import torch

    from automoe_tpu_torch.serving.quant import s2d_stem_pool_unfused

    res = {}
    for B in (1, 2, B_MAIN, 128):
        args = stem_inputs(B, gen)
        out, max_err, frac, mixed_err, mixed_frac = k3_against_plain(stem, args, gen)
        xs, w, bias, inv = args
        flops = 2.0 * B * 128 * 128 * 192 * 256
        b_ms, b_by = bound(flops, PEAK_BF16_FLOPS, nbytes(*args, out))
        unfused = (xs, w.reshape(4, 4, 12, -1).permute(3, 2, 0, 1).contiguous(),
                   bias.bfloat16(), inv)
        blocks = stem_kernel_ms(stem, *args)
        res[B] = dict(max_abs_err=max_err, diff_frac=frac, mixed_sign_inv_max_abs_err=mixed_err,
                      mixed_sign_inv_diff_frac=mixed_frac,
                      ms=float(np.median(blocks)), ms_blocks=blocks,
                      wrapper_ms=cuda_ms_median(lambda: stem.s2d_stem_pool_int8(*args),
                                                iters=30),
                      plain_ms=cuda_ms(lambda: stem.s2d_stem_pool_int8_plain(*args), 5),
                      unfused_ms=float(np.median(
                          [cuda_ms(lambda: s2d_stem_pool_unfused(*unfused), iters=20)
                           for _ in range(3)])),
                      bound_ms=b_ms, bound_by=b_by)
        print(f"K3 B={B}: {res[B]}", flush=True)
    return res


def phase_k3_f32(stem, gen):
    """K3's f32 instantiation against its plain version at B=8 and B=32,
    256x256 input, O = 256, TF32 off (so the plain conv is an f32 one):
    int8 outputs within ±1 on at most 0.1% of elements, with inv > 0 and
    with inv of both signs, and at most 5e-5 of them off (f32's level: the
    kernel splits each value into two TF32 parts). Times: the kernel alone
    (three blocks of 20 back-to-back launches, the median block), its
    wrapper (median of 20 calls) and the plain version (mean of 5). Bound:
    the kernel's three TF32 passes (hi*hi, hi*lo, lo*hi) over the dense
    TF32 peak, or the bytes."""
    import torch

    res = {}
    for B in (B_MAIN, 32):
        xs = torch.randn(B, 132, 132, 12, device="cuda", generator=gen)
        w = torch.randn(192, 256, device="cuda", generator=gen) * 0.05
        bias = torch.randn(256, device="cuda", generator=gen) * 0.1
        inv = 127.0 / (torch.rand(256, device="cuda", generator=gen) * 4 + 1)
        args = (xs, w, bias, inv)
        out, max_err, frac, mixed_err, mixed_frac = k3_against_plain(stem, args, gen)
        assert frac <= 5e-5 and mixed_frac <= 5e-5, (B, frac, mixed_frac)
        flops = 3 * 2.0 * B * 128 * 128 * 192 * 256
        b_ms, b_by = bound(flops, PEAK_TF32_FLOPS, nbytes(*args, out))
        blocks = stem_kernel_ms(stem, *args, iters=20,
                                entry="automoe_stem_s2d_pool_int8_f32")
        res[B] = dict(max_abs_err=max_err, diff_frac=frac, mixed_sign_inv_max_abs_err=mixed_err,
                      mixed_sign_inv_diff_frac=mixed_frac,
                      ms=float(np.median(blocks)), ms_blocks=blocks,
                      wrapper_ms=cuda_ms_median(lambda: stem.s2d_stem_pool_int8(*args),
                                                iters=20),
                      plain_ms=cuda_ms(lambda: stem.s2d_stem_pool_int8_plain(*args), 5),
                      bound_ms=b_ms, bound_by=b_by)
        print(f"K3 f32 B={B}: {res[B]}", flush=True)
    return res


def pool_kernel_ms(stem, x, blocks: int = 3, iters: int = 50) -> list:
    """K4 alone: the library's entry point launched back to back on a
    pre-built input (no wrapper checks, no launch count), CUDA events
    around each block of `iters` launches; the mean of each block."""
    import torch

    lib = stem.build()
    B, H, W, C = x.shape
    out = torch.empty((B, *stem.pool_out_hw(H, W), C), dtype=torch.int8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        stem.raise_on(lib.automoe_maxpool3x3s2_int8(x.data_ptr(), out.data_ptr(), B, H, W, C,
                                                    stream), "maxpool3x3s2_int8")

    return [cuda_ms(launch, iters=iters) for _ in range(blocks)]


def phase_k4(stem, gen):
    """No single PyTorch call computes it on CUDA: max_pool2d has no int8
    kernel there, so the line's library_ms is null. Times: the kernel alone
    (the median of three blocks of 50 back-to-back launches), its wrapper
    (median of 30 calls, one event pair each), the plain version (mean of 5)."""
    import torch

    res = {}
    for B in (B_MAIN, 128):
        x = torch.randint(0, 128, (B, 128, 128, 256), device="cuda", dtype=torch.int8,
                          generator=gen)
        out = stem.maxpool3x3s2_int8(x)
        torch.cuda.synchronize()
        ref = stem.maxpool3x3s2_int8_plain(x)
        assert torch.equal(out, ref), "K4 differs from its plain version"
        # 8 int8 max operations per output element; the bytes bound it
        b_ms, b_by = bound(8.0 * out.numel(), PEAK_INT8_OPS, nbytes(x, out))
        blocks = pool_kernel_ms(stem, x)
        res[B] = dict(max_abs_err=int((out.int() - ref.int()).abs().max()), diff_frac=0.0,
                      ms=float(np.median(blocks)), ms_blocks=blocks,
                      wrapper_ms=cuda_ms_median(lambda: stem.maxpool3x3s2_int8(x), iters=30),
                      plain_ms=cuda_ms(lambda: stem.maxpool3x3s2_int8_plain(x), 5),
                      bound_ms=b_ms, bound_by=b_by)
        print(f"K4 B={B}: {res[B]}", flush=True)
    return res


def kernel_ms(ak, benefit, valid, eps, max_iters: int, blocks: int = 3,
              iters: int = 50) -> list:
    """K1+K2 alone: the library's entry point launched back to back on
    pre-masked int32 inputs (no wrapper ops, no launch count), CUDA events
    around each block of `iters` launches; the mean of each block."""
    import torch

    lib = ak.build()
    B, N, Q = benefit.shape
    b = torch.where(valid[..., None], benefit, torch.zeros_like(benefit)).float().contiguous()
    v = valid.to(torch.int32).contiguous()
    e = eps.float().contiguous()
    out = torch.empty(B, N, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        ak.raise_on(lib.automoe_auction_solve(b.data_ptr(), v.data_ptr(), e.data_ptr(),
                                              out.data_ptr(), B, N, Q, max_iters, 1, stream),
                    "auction_solve")

    return [cuda_ms(launch, iters=iters) for _ in range(blocks)]


def phase_auction(ak, regimes):
    """K1+K2 on each (name, benefit, valid, eps, max_iters) of `regimes`."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from automoe_tpu_torch.tools.bench_auction import scipy_gap_limit

    res = {}
    for name, benefit, valid, eps, max_iters in regimes:
        out = ak.auction_solve(benefit, valid, eps, max_iters=max_iters)
        torch.cuda.synchronize()
        masked = torch.where(valid[..., None], benefit, torch.zeros_like(benefit))
        ref = ak.auction_solve_plain(masked, valid, eps, max_iters=max_iters)
        assert torch.equal(out, ref), f"auction kernel differs from its plain version ({name})"
        counts = ak.auction_counts_plain(masked, valid, eps, max_iters)
        escalated = int(counts["escalated"].sum())
        # the escalate=False branch (greedy completion), held against its plain version
        greedy = ak.auction_solve(benefit, valid, eps, max_iters=max_iters, escalate=False)
        torch.cuda.synchronize()
        assert torch.equal(greedy, ak.auction_solve_plain(
            masked, valid, eps, max_iters=max_iters, escalate=False)), f"greedy differs ({name})"
        gap = rel_gap = 0.0
        cost = (-benefit).double().cpu().numpy()
        o, v = out.cpu().numpy(), valid.cpu().numpy()
        for b in range(cost.shape[0]):
            rows = np.where(v[b])[0]
            if not len(rows):
                assert (o[b] == -1).all()
                continue
            sub = cost[b][rows]
            ri, ci = linear_sum_assignment(sub)
            opt = sub[ri, ci].sum()
            g = float(abs(sub[np.arange(len(rows)), o[b][rows]].sum() - opt))
            assert g <= scipy_gap_limit(opt), (name, b, g, opt)
            gap, rel_gap = max(gap, g), max(rel_gap, g / max(float(abs(opt)), 1e-30))
        valid_i = valid.int()
        b_ms, b_by = bound(0.0, PEAK_BF16_FLOPS, nbytes(benefit, valid_i, eps, out))
        blocks = kernel_ms(ak, benefit, valid, eps, max_iters)
        res[name] = dict(
            shape=list(benefit.shape), max_abs_err=int((out - ref).abs().max()),
            escalated=escalated,
            rounds_max=int(counts["rounds"].max()), jv_scans_max=int(counts["jv_scans"].max()),
            max_iters=max_iters, scipy_cost_gap=gap, scipy_cost_gap_rel=rel_gap,
            ms=float(np.median(blocks)), ms_blocks=blocks,
            wrapper_ms=cuda_ms_median(lambda: ak.auction_solve(benefit, valid, eps,
                                                               max_iters=max_iters), iters=30),
            plain_ms=cuda_ms_median(lambda: ak.auction_solve_plain(
                masked, valid, eps, max_iters=max_iters), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by)
        print(f"K1+K2 {name}: {res[name]}", flush=True)
    return res


def steps_card_vs_cpu(wl, batches, what: str):
    """SGD steps of workload `wl` on the card (its kernel) and on the CPU
    (the plain version) from one seed's weights, dropout off: K1 launched
    once per card step, losses within rtol 1e-4, parameters and BatchNorm
    statistics within rtol 1e-3 / atol 1e-5."""
    import torch

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step

    step = make_train_step(wl.loss_fn)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(SEED, torch.device(dev))
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, weight_decay=0.0,
                             total_steps=len(batches), optimizer="sgd")
        n0 = ak.LAUNCHES["auction_solve"]
        losses = [float(step(model, opt, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()})["loss"]) for b in batches]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     ak.LAUNCHES["auction_solve"] - n0)
    assert runs["cuda"][2] == len(batches) and runs["cpu"][2] == 0, \
        f"{what}: K1 not launched once per card step"
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    worst = 0.0
    for k, v in runs["cpu"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
            worst = max(worst, float((runs["cuda"][1][k] - v).abs().max()))
    print(f"{what}: cuda losses {runs['cuda'][0]} cpu losses {runs['cpu'][0]}, "
          f"max param diff {worst:.3e}", flush=True)
    return {"losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
            "max_param_abs_diff": worst}


def phase_train_step():
    """Two SGD detection steps on the card (K1) and on the CPU (plain version)."""
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(2):
        xy1 = rng.uniform(0.05, 0.45, (2, 4, 2))
        xy2 = rng.uniform(0.55, 0.95, (2, 4, 2))
        labels = rng.integers(0, 10, (2, 4)).astype(np.int32)
        labels[0, -1] = -1
        batches.append({"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
                        "bboxes": np.concatenate([xy1, xy2], -1).astype(np.float32),
                        "labels": labels})
    return steps_card_vs_cpu(bdd_expert_workload("detection", matcher="auction_kernel"),
                             batches, "train step")


def phase_train_cli(tmp: Path):
    """automoe-train-torch on synthetic caches; returns per-subcommand results."""
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import synth_bdd_detection, synth_carla_detection
    from automoe_tpu_torch.train.cli import main as train_main

    runs = {"finetune-carla": (synth_carla_detection, 2), "bdd": (synth_bdd_detection, 1)}
    out = {}
    for cmd, (synth, epochs) in runs.items():
        root = synth(tmp / cmd, n_per_split={"train": 64, "val": 32}, size=256,
                     max_boxes=20, seed=SEED)
        ak.reset_launch_counts()
        res = train_main([cmd, "--task", "detection", "--data-root", str(root),
                          "--image-size", "256", "--box-cap", "48", "--batch-size", "32",
                          "--epochs", str(epochs), "--runs-root", str(tmp / "runs"),
                          "--run-name", cmd])
        launches = ak.LAUNCHES["auction_solve"]
        steps = epochs * (64 // 32 + 32 // 32)
        assert launches == steps, (cmd, launches, steps)
        recs = [json.loads(line) for line in
                (tmp / "runs" / f"bdd_detection_{cmd}" / "metrics.jsonl").read_text().splitlines()]
        losses = [r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r]
        vals = [r["val/loss"] for r in recs if "val/loss" in r]
        assert len(losses) == len(vals) == epochs and np.isfinite(losses + vals).all(), recs
        out[cmd] = dict(launches=launches, train_loss_epoch=losses, val_loss=vals,
                        step_ms_p50=res["step_ms_p50"], timed_steps=res["timed_steps"],
                        samples_per_s=32 * 1e3 / res["step_ms_p50"])
        print(f"train CLI {cmd}: {out[cmd]}", flush=True)
    return out


def metrics_of(run_dir: Path):
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return ([r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r],
            [r["val/loss"] for r in recs if "val/loss" in r])


def serve_four(argv, frames, speeds, kernel: str = "s2d_stem_pool_int8"):
    """automoe-serve-torch with `argv` answers 4 concurrent TCP requests;
    returns (server batches, launches of the stem kernel `kernel` counted
    from 0 around them; no other stem kernel may launch)."""
    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.serving import Client
    from automoe_tpu_torch.serving.cli import main as serve_main

    srv, batcher = serve_main(argv + ["--port", "0", "--max-batch", "4"], block=False)
    try:
        host, port = srv.server_address[:2]
        answers = [None] * 4
        stem.reset_launch_counts()

        def ask(i):
            c = Client(host, port)
            answers[i] = c.infer(frames[i], float(speeds[i]))
            c.close()

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        counts = dict(stem.LAUNCHES)
        n_batches = batcher.stats["batches"]
    finally:
        srv.shutdown()
        batcher.close()
    for a in answers:
        assert a is not None and a["waypoints"].shape == (10, 2)
        assert np.isfinite(a["waypoints"]).all()
        np.testing.assert_allclose(a["expert_weights"].sum(), 1.0, rtol=1e-2)
    launches = counts.pop(kernel)
    assert launches == n_batches >= 1 and not any(counts.values()), (kernel, launches, counts,
                                                                      n_batches)
    return n_batches, launches


def phase_pipeline(tmp: Path, frames, speeds):
    """detection → checkpoint → resume → gating with the expert grafted →
    policy → int8 serving of the gating checkpoint, through the entry
    points at full width."""
    import torch

    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import synth_carla_detection, synth_carla_sequence
    from automoe_tpu_torch.train.cli import main as train_main

    ck, runs = tmp / "ckpt", tmp / "runs"
    out = {}
    det_root = synth_carla_detection(tmp / "det", n_per_split={"train": 64, "val": 32},
                                     size=256, max_boxes=20, seed=SEED)
    det = ["finetune-carla", "--task", "detection", "--data-root", str(det_root),
           "--image-size", "256", "--box-cap", "48", "--batch-size", "32", "--save-freq", "1",
           "--ckpt-root", str(ck), "--runs-root", str(runs), "--run-name", "det"]
    ak.reset_launch_counts()
    train_main(det + ["--epochs", "1"])
    first = ak.LAUNCHES["auction_solve"]
    last1 = load_checkpoint(ck / "bdd_detection" / "det" / "last.pt")
    ak.reset_launch_counts()
    res = train_main(det + ["--epochs", "2", "--resume", "full", "--resume-from", "last"])
    resumed = ak.LAUNCHES["auction_solve"]
    last2 = load_checkpoint(ck / "bdd_detection" / "det" / "last.pt")
    steps = 64 // 32
    # K1 once per train and eval step, of the resumed epoch only
    assert first == resumed == steps + 1, (first, resumed)
    assert (last1["epoch"], last1["step"]) == (0, steps), (last1["epoch"], last1["step"])
    assert (last2["epoch"], last2["step"]) == (1, 2 * steps), (last2["epoch"], last2["step"])
    losses, vals = metrics_of(runs / "bdd_detection_det")
    assert len(losses) == len(vals) == 2 and np.isfinite(losses + vals).all()
    out["detection_resume"] = dict(launches_epoch1=first, launches_resumed_epoch2=resumed,
                                   step_after_epoch1=last1["step"],
                                   step_after_resume=last2["step"], train_loss_epoch=losses,
                                   val_loss=vals, step_ms_p50=res["step_ms_p50"])
    print(f"pipeline detection + resume: {out['detection_resume']}", flush=True)

    # 2 runs of 74 frames: 128 gating windows (horizon 10: 16 steps at batch
    # 8), 132 policy ones (horizon 8: 4 steps at batch 32)
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"train": 148, "val": 26}, runs=2,
                               size=256, seed=SEED)
    det_best = ck / "bdd_detection" / "det" / "best.pt"
    for cmd, batch, extra in (("gating", 8, ["--expert-ckpts", f"{det_best},,,"]),
                              ("policy", 32, [])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = train_main([cmd, "--data-root", str(seq), "--image-size", "256", "--batch-size",
                          str(batch), "--epochs", "1", "--ckpt-root", str(ck), "--runs-root",
                          str(runs), "--run-name", cmd, *extra])
        peak = torch.cuda.max_memory_allocated()
        name = "gating" if cmd == "gating" else "carla_policy"
        losses, vals = metrics_of(runs / f"{name}_{cmd}")
        assert len(losses) == len(vals) == 1 and np.isfinite(losses + vals).all(), cmd
        out[cmd] = dict(batch=batch, train_loss_epoch=losses, val_loss=vals,
                        step_ms_p50=res["step_ms_p50"], step_ms_mean=res["step_ms_mean"],
                        timed_steps=res["timed_steps"],
                        samples_per_s=batch * 1e3 / res["step_ms_p50"],
                        peak_memory_bytes=int(peak))
        print(f"pipeline {cmd}: {out[cmd]}", flush=True)
    gating_best = ck / "gating" / "gating" / "best.pt"
    det_sd = load_checkpoint(det_best)["model_state_dict"]
    g_sd = load_checkpoint(gating_best)["model_state_dict"]
    stats = ("running_mean", "running_var", "num_batches_tracked")
    frozen = [k for k in det_sd if not k.endswith(stats)]
    assert all(torch.equal(g_sd[f"experts.0.{k}"], det_sd[k]) for k in frozen)
    out["gating"]["expert0_params_equal_detection_best"] = len(frozen)

    n_batches, launches = serve_four(["--checkpoint", str(gating_best), "--quantize"],
                                     frames, speeds)
    out["serve_gating_int8"] = dict(batches=n_batches, k3_launches=launches)
    print(f"pipeline serving of the gating checkpoint: {out['serve_gating_int8']}", flush=True)
    return out


#: the seed of phase 13's card-vs-CPU nuScenes batches: one whose exact
#: matches have no near-tie along the two steps (on the CPU, outputs moved
#: by 3e-5 relative noise keep every match in 30 draws a step; seeds 0, 3
#: and 4 flip one), so the card and the CPU cannot fork on one
NUS_STEP_SEED = 5


def nuscenes_step_batches(seed: int = NUS_STEP_SEED):
    """Two seeded nuScenes batches: B=8, 64x64, 256 points, 4 boxes."""
    from automoe_tpu_torch.tools.synth import nuscenes_batch

    rng = np.random.default_rng(seed)
    return [nuscenes_batch(rng, 8, size=64, points=256, nbox=4) for _ in range(2)]


def train_cli_run(argv, run_dir: Path):
    """One `automoe-train-torch` run with K1+K2 launches counted from 0 and
    peak memory from a reset: (result, launches, peak bytes, metrics
    records)."""
    import torch

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.train.cli import main as train_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.reset_launch_counts()
    res = train_main(argv)
    launches = ak.LAUNCHES["auction_solve"]
    peak = torch.cuda.max_memory_allocated()
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return res, launches, int(peak), recs


def phase_other_experts(tmp: Path, frames, speeds):
    """The segmentation, drivable and nuScenes trainers through the entry
    point at full width, and int8 serving of a LiDAR config."""
    import torch

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.tools.synth import (synth_bdd_segmentation, synth_carla_detection,
                                               synth_carla_segmentation, synth_nuscenes)

    out = {}
    runs = tmp / "runs"
    common = ["--image-size", "256", "--runs-root", str(runs), "--ckpt-root", str(tmp / "ck")]
    split = {"train": 64, "val": 32}
    nus = synth_nuscenes(tmp / "nus", n_per_split=split, size=256, points=8192, seed=SEED)
    det = synth_carla_detection(tmp / "det", n_per_split=split, size=256, max_boxes=20,
                                seed=SEED)
    seg_split = {"train": 128, "val": 32}
    cases = [
        ("nuscenes", ["nuscenes", "--use-lidar", "--use-tnet", "--fusion", "concat",
                      "--data-root", str(nus), "--batch-size", "32", "--lidar-cap", "8192",
                      "--box-cap", "48", "--num-queries", "100", "--epochs", "2"],
         "nuscenes", 32, 2 * (64 // 32 + 32 // 32)),
        ("nuscenes-2d", ["nuscenes-2d", "--data-root", str(det), "--batch-size", "16",
                         "--box-cap", "48", "--num-queries", "196", "--epochs", "1"],
         "carla_nuscenes_2d", 16, 64 // 16 + 32 // 16),
        ("finetune-carla drivable",
         ["finetune-carla", "--task", "drivable", "--batch-size", "16", "--epochs", "1",
          "--data-root", str(synth_carla_segmentation(tmp / "cseg", n_per_split=seg_split,
                                                      size=256, seed=SEED))],
         "bdd_drivable", 16, 0),
        ("bdd segmentation",
         ["bdd", "--task", "segmentation", "--batch-size", "32", "--epochs", "1",
          "--data-root", str(synth_bdd_segmentation(tmp / "bseg", n_per_split=seg_split,
                                                    size=256, seed=SEED))],
         "bdd_segmentation", 32, 0),
    ]
    for name, argv, workload, batch, want_launches in cases:
        run = name.replace(" ", "-")
        res, launches, peak, recs = train_cli_run(argv + common + ["--run-name", run],
                                                  runs / f"{workload}_{run}")
        assert launches == want_launches, (name, launches, want_launches)
        losses = [r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r]
        vals = [r for r in recs if "val/loss" in r]
        assert losses and len(vals) == len(losses), (name, recs)
        assert np.isfinite(losses + [r["val/loss"] for r in vals]).all(), (name, recs)
        out[name] = dict(batch=batch, kernel_launches=launches, train_loss_epoch=losses,
                         val_loss=[r["val/loss"] for r in vals],
                         step_ms_p50=res["step_ms_p50"], step_ms_mean=res["step_ms_mean"],
                         timed_steps=res["timed_steps"],
                         samples_per_s=batch * 1e3 / res["step_ms_p50"],
                         peak_memory_bytes=peak)
        if workload.startswith("bdd_"):
            for k in ("pixel_acc", "mean_iou"):
                got = [r[f"val/{k}"] for r in vals]
                assert all(0.0 <= v <= 1.0 for v in got), (name, k, got)
                out[name][k] = got
        print(f"phase 13 {name}: {out[name]}", flush=True)

    cfg = default_model_config().to_json()
    cfg["experts"][3].update(use_lidar=True, use_tnet=True, fusion="concat")
    n_batches, k3 = serve_four(["--quantize", "--model-config", json.dumps(cfg)], frames, speeds)
    out["serve_lidar_int8"] = dict(batches=n_batches, k3_launches=k3)
    print(f"phase 13 int8 serving of a LiDAR config: {out['serve_lidar_int8']}", flush=True)
    torch.cuda.empty_cache()
    return out


def phase_step_options_card_vs_cpu():
    """14a: an accumulated step and a two-step call, card against CPU,
    without and with --qat. Without, phase 10's tolerances. With, the
    tolerance is QAT's own sensitivity, measured in the same phase: the
    activation fake-quant rounds values that two devices compute 1e-6
    apart, and a value on either side of a rounding boundary moves one
    grid step (1/127 of the tensor's absmax); over three steps that
    compounds (on the CPU alone, the same steps on images scaled by
    1 + 1e-6 move the losses by ~4e-4 and a BatchNorm running variance by
    ~1e-2). So the card's largest loss and state differences from the
    CPU must stay within 10x those of the CPU's own perturbed run."""
    import torch

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_grad_accum_train_step, make_scan_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    rng = np.random.default_rng(SEED + 14)
    batches = []
    for _ in range(4):
        xy1 = rng.uniform(0.05, 0.45, (2, 4, 2)) * 64
        xy2 = rng.uniform(0.55, 0.95, (2, 4, 2)) * 64
        labels = rng.integers(0, 10, (2, 4)).astype(np.int32)
        labels[0, -1] = -1
        batches.append({"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
                        "bboxes": np.concatenate([xy1, xy2], -1).astype(np.float32),
                        "labels": labels})
    groups = [{k: np.stack([b[k] for b in pair]) for k in pair[0]}
              for pair in (batches[:2], batches[2:])]

    def run(wl, dev, image_scale=1.0):
        model = wl.init_model(SEED, torch.device(dev))
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, weight_decay=0.0,
                             total_steps=3, optimizer="sgd", ema_decay=0.9)
        accum, scan = make_grad_accum_train_step(wl.loss_fn), make_scan_train_step(wl.loss_fn)
        n0 = ak.LAUNCHES["auction_solve"]
        g = [{k: torch.from_numpy(v * image_scale if k == "image" else v).to(dev)
              for k, v in grp.items()} for grp in groups]
        m1 = accum(model, opt, g[0], (SEED + 1, opt.count))
        m2 = scan(model, opt, g[1], (SEED + 1, opt.count))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if v.is_floating_point()}
        state.update({f"ema.{k}": v.cpu() for k, v in opt.ema.state_dict().items()})
        assert opt.count == 3
        return ([float(m1["loss"])] + m2["loss"].tolist(), state,
                ak.LAUNCHES["auction_solve"] - n0)

    def diffs(a, b):
        loss = float(np.max(np.abs(np.subtract(a[0], b[0])) / np.abs(b[0])))
        return loss, max(float((a[1][k] - b[1][k]).abs().max()) for k in b[1])

    out = {}
    for qat in (False, True):
        wl = bdd_expert_workload("detection", matcher="auction_kernel", qat=qat, augment=True)
        card, cpu = run(wl, "cuda"), run(wl, "cpu")
        assert card[2] == 4 and cpu[2] == 0, "K1 not launched once per microbatch and step"
        loss_diff, state_diff = diffs(card, cpu)
        res = {"losses_cuda": card[0], "losses_cpu": cpu[0], "max_loss_rel_diff": loss_diff,
               "max_state_abs_diff": state_diff, "k1_launches_cuda": card[2]}
        if not qat:
            np.testing.assert_allclose(card[0], cpu[0], rtol=1e-4)
            for k, v in cpu[1].items():
                np.testing.assert_allclose(card[1][k].numpy(), v.numpy(), rtol=1e-3,
                                           atol=1e-5, err_msg=k)
        else:
            floor_loss, floor_state = diffs(run(wl, "cpu", np.float32(1 + 1e-6)), cpu)
            res.update(cpu_perturbed_loss_rel_diff=floor_loss,
                       cpu_perturbed_state_abs_diff=floor_state)
            assert loss_diff <= 10 * max(floor_loss, 1e-6), res
            assert state_diff <= 10 * max(floor_state, 1e-5), res
        out["qat" if qat else "float"] = res
        print(f"phase 14a ({'qat' if qat else 'float'}) grad-accum + steps-per-call, "
              f"card vs CPU: {res}", flush=True)
    return out


def phase_step_options(tmp: Path, frames, speeds):
    """14b-e: the step options through the entry points at full width."""
    import torch

    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.tools.synth import (synth_bdd_detection, synth_bdd_segmentation,
                                               synth_carla_detection, synth_carla_sequence)

    out = {}
    runs, ck = tmp / "runs", tmp / "ck"
    common = ["--image-size", "256", "--epochs", "1", "--runs-root", str(runs),
              "--ckpt-root", str(ck)]
    det = ["--task", "detection", "--box-cap", "48", "--batch-size", "32"]
    prof = tmp / "prof"
    bdd = synth_bdd_detection(tmp / "bdd", n_per_split={"train": 192, "val": 32}, size=256,
                              max_boxes=20, seed=SEED)
    carla = synth_carla_detection(tmp / "carla", n_per_split={"train": 256, "val": 32},
                                  size=256, max_boxes=20, seed=SEED)
    seg = synth_bdd_segmentation(tmp / "seg", n_per_split={"train": 64, "val": 32}, size=256,
                                 seed=SEED)
    options = ["bdd", *det, "--data-root", str(bdd), "--bf16", "--augment", "--qat", "--remat",
               "--ema-decay", "0.999", "--grad-accum", "2", "--max-inflight", "2"]
    cases = [
        # the trace covers the whole (one) epoch, so its times carry the
        # profiler's cost; the same run again without it gives the times
        ("b", options + ["--profile-dir", str(prof)], "bdd_detection", 64, 192 // 32 + 2),
        ("b-unprofiled", options, "bdd_detection", 64, 192 // 32 + 2),
        ("c", ["finetune-carla", *det, "--data-root", str(carla), "--steps-per-call", "4"],
         "bdd_detection", 128, 256 // 32 + 1),
        ("d", ["bdd", "--task", "segmentation", "--batch-size", "32", "--data-root", str(seg),
               "--augment", "--bf16"], "bdd_segmentation", 32, 0),
    ]
    # samples: a call's (b: 2 microbatches, c: 4 steps of 32)
    for name, argv, workload, samples, want in cases:
        res, launches, peak, recs = train_cli_run(argv + common + ["--run-name", name],
                                                  runs / f"{workload}_{name}")
        assert launches == want, (name, launches, want)
        losses = [r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r]
        vals = [r["val/loss"] for r in recs if "val/loss" in r]
        assert len(losses) == len(vals) == 1 and np.isfinite(losses + vals).all(), (name, recs)
        out[name] = dict(kernel_launches=launches, train_loss_epoch=losses, val_loss=vals,
                         call_ms_p50=res["step_ms_p50"], call_ms_mean=res["step_ms_mean"],
                         timed_calls=res["timed_steps"],
                         samples_per_s=samples * 1e3 / res["step_ms_p50"],
                         peak_memory_bytes=peak)
        if name == "b":
            ema = [r["val_ema/loss"] for r in recs if "val_ema/loss" in r]
            assert len(ema) == 1 and np.isfinite(ema).all(), recs
            traces = list(prof.glob("trace_*.json"))
            assert traces and traces[0].stat().st_size > 0, "no profiler trace"
            out[name].update(val_ema_loss=ema, trace_bytes=traces[0].stat().st_size)
        if name == "d":
            acc = [r["val/pixel_acc"] for r in recs if "val/pixel_acc" in r]
            assert acc and all(0.0 <= a <= 1.0 for a in acc), recs
            out[name]["pixel_acc"] = acc
        print(f"phase 14{name}: {out[name]}", flush=True)

    # (e) gating with (b)'s expert grafted and an EMA, served from its EMA
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"train": 148, "val": 26}, runs=2,
                               size=256, seed=SEED)
    det_best = ck / "bdd_detection" / "b" / "best.pt"
    res, _, peak, recs = train_cli_run(
        ["gating", "--data-root", str(seq), "--batch-size", "8", "--expert-ckpts",
         f"{det_best},,,", "--ema-decay", "0.999", *common, "--run-name", "e"],
        runs / "gating_e")
    ema = [r["val_ema/loss"] for r in recs if "val_ema/loss" in r]
    assert len(ema) == 1 and np.isfinite(ema).all(), recs
    gating_best = ck / "gating" / "e" / "best.pt"
    expert = load_checkpoint(det_best)["model_state_dict"]
    g_ema = load_checkpoint(gating_best)["ema_state_dict"]
    grafted = [k for k in expert if f"experts.0.{k}" in g_ema]
    assert grafted
    for k in grafted:
        np.testing.assert_allclose(g_ema[f"experts.0.{k}"].numpy(), expert[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    n_batches, k3 = serve_four(["--checkpoint", str(gating_best), "--ema", "--quantize"],
                               frames, speeds)
    out["e"] = dict(gating_val_ema_loss=ema, gating_step_ms_p50=res["step_ms_p50"],
                    gating_peak_memory_bytes=peak, ema_params_checked=len(grafted),
                    serve_batches=n_batches, k3_launches=k3)
    print(f"phase 14e: {out['e']}", flush=True)
    torch.cuda.empty_cache()
    return out


def phase_packed_reader(tmp: Path):
    """15a: the native reader (built in phase 1) against the python memmap
    reader on a packed 256x256 CARLA detection cache, byte for byte, and
    each one's host time for a batch of 32."""
    from automoe_tpu_torch.data.native_packed import NativePackedDataset
    from automoe_tpu_torch.data.packed import PackedFrameDataset, pack_frames
    from automoe_tpu_torch.data.datasets import CarlaDetectionDataset
    from automoe_tpu_torch.tools.synth import synth_carla_detection

    root = synth_carla_detection(tmp / "det", n_per_split={"train": 64}, size=256,
                                 max_boxes=20, seed=SEED)
    n = pack_frames(CarlaDetectionDataset(root / "train", box_cap=48), tmp / "packed")
    native, python = NativePackedDataset(tmp / "packed"), PackedFrameDataset(tmp / "packed")
    idx = np.random.default_rng(SEED).permutation(n)[:32]
    a, b = native.read_batch(idx), python.read_batch(idx)
    assert sorted(a) == sorted(b) == ["bboxes", "image", "labels"], sorted(a)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k

    def host_ms(fn, iters=10):
        t = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(idx)
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))

    out = dict(samples=n, batch=32, fields=sorted(a), image_row_dtype=str(
        np.load(tmp / "packed" / "image.npy", mmap_mode="r").dtype),
               native_read_ms=host_ms(native.read_batch),
               python_read_ms=host_ms(python.read_batch))
    print(f"phase 15a packed reader: {out}", flush=True)
    return out


def phase_fast_data(tmp: Path, det_best: Path, gating_plain: dict, frames, speeds):
    """15b-e: the packed caches and the cached, device-resident gating
    trainer through the entry points at full width."""
    import torch

    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.data.pack_cli import main as pack_main
    from automoe_tpu_torch.tools.synth import synth_bdd_detection, synth_carla_sequence
    from automoe_tpu_torch.train import feature_cache
    from automoe_tpu_torch.train.cli import main as train_main

    out = {}
    runs, ck = tmp / "runs", tmp / "ck"
    common = ["--image-size", "256", "--runs-root", str(runs), "--ckpt-root", str(ck)]
    # (b) bdd detection from PNG frames, then from their packed cache
    bdd = synth_bdd_detection(tmp / "bdd", n_per_split={"train": 64, "val": 32}, size=256,
                              max_boxes=20, seed=SEED)
    t0 = time.perf_counter()
    counts = pack_main(["bdd-detection", "--root", str(bdd), "--out", str(tmp / "bdd-packed"),
                        "--box-cap", "48"])
    pack_s = time.perf_counter() - t0
    det = ["bdd", "--task", "detection", "--box-cap", "48", "--batch-size", "32",
           "--epochs", "2", *common]
    b = {}
    for name, src in (("data-root", ["--data-root", str(bdd)]),
                      ("packed-root", ["--packed-root", str(tmp / "bdd-packed")])):
        res, launches, peak, recs = train_cli_run(det + src + ["--run-name", name],
                                                  runs / f"bdd_detection_{name}")
        assert launches == 2 * (64 // 32 + 32 // 32), (name, launches)
        losses = [r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r]
        vals = [r["val/loss"] for r in recs if "val/loss" in r]
        assert len(losses) == len(vals) == 2 and np.isfinite(losses + vals).all(), (name, recs)
        b[name] = dict(k1_launches=launches, train_loss_epoch=losses, val_loss=vals,
                       step_ms_p50=res["step_ms_p50"], step_ms_mean=res["step_ms_mean"],
                       timed_steps=res["timed_steps"], peak_memory_bytes=peak)
    out["b"] = dict(pack_seconds=pack_s, packed=counts, **b)
    print(f"phase 15b bdd detection, PNG frames vs packed cache: {out['b']}", flush=True)

    # (c) cached, device-resident gating on a packed sequence cache; then again,
    # the cache loaded from --feature-cache-dir
    # 2 runs of 138 frames: 256 train windows (horizon 10), 2 groups of 4
    # steps of 32 an epoch
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"train": 276, "val": 26}, runs=2,
                               size=256, seed=SEED)
    windows = pack_main(["carla-sequences", "--root", str(seq), "--out",
                         str(tmp / "seq-packed"), "--horizon", "10"])
    computed = []
    precompute = feature_cache.precompute_pooled_features

    def counted(*a, **k):
        computed.append(len(a[1]))
        return precompute(*a, **k)

    feature_cache.precompute_pooled_features = counted
    try:
        gating = ["gating", "--packed-root", str(tmp / "seq-packed"), "--expert-ckpts",
                  f"{det_best},,,", "--cache-expert-features", "--feature-cache-dir",
                  str(tmp / "fc"), "--device-resident", "--steps-per-call", "4",
                  "--batch-size", "32", *common]
        c = {}
        for name, epochs in (("first", "2"), ("again", "1")):
            computed.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = train_main(gating + ["--epochs", epochs, "--run-name", name])
            wall = time.perf_counter() - t0
            losses, vals = metrics_of(runs / f"gating_{name}")
            assert len(losses) == len(vals) == int(epochs), (name, losses, vals)
            assert np.isfinite(losses + vals).all(), (name, losses, vals)
            c[name] = dict(precomputed_samples=list(computed), train_loss_epoch=losses,
                           val_loss=vals, call_ms_p50=res["step_ms_p50"],
                           call_ms_mean=res["step_ms_mean"], timed_calls=res["timed_steps"],
                           samples_per_s=4 * 32 * 1e3 / res["step_ms_p50"],
                           run_seconds=wall,
                           peak_memory_bytes=int(torch.cuda.max_memory_allocated()))
        # each split's windows, cached once
        assert c["first"]["precomputed_samples"] == [windows["train"], windows["val"]], c
        assert windows["train"] == 256, windows
        assert c["again"]["precomputed_samples"] == [], "the cache was not loaded from disk"
    finally:
        feature_cache.precompute_pooled_features = precompute
    out["c"] = dict(c, plain_gating_step_ms_p50_phase12=gating_plain["step_ms_p50"],
                    plain_gating_batch_phase12=gating_plain["batch"])
    print(f"phase 15c cached device-resident gating: {out['c']}", flush=True)

    # (e) the cache-trained gating checkpoint served int8
    best = ck / "gating" / "first" / "best.pt"
    assert any(k.startswith("experts.3.") for k in load_checkpoint(best)["model_state_dict"])
    n_batches, k3 = serve_four(["--checkpoint", str(best), "--quantize"], frames, speeds)
    out["e"] = dict(serve_batches=n_batches, k3_launches=k3)
    print(f"phase 15e int8 serving of the cached gating checkpoint: {out['e']}", flush=True)
    torch.cuda.empty_cache()
    return out


def phase_cached_step_equals_experts_eval():
    """15d: on the card, one step of the cached gating workload equals the
    experts_eval step from the same weights and key, at the default
    4-expert config, 256x256, B=8, TF32 off: loss rtol 1e-5, trained
    parameters rtol 1e-3 / atol 1e-4 (the tolerances of the JAX package's
    tests/test_feature_cache.py), the experts' parameters and statistics
    bit-equal to the start in both. The step is SGD at lr 1e-2: the policy
    backbone's conv biases feed train-mode BatchNorm, so their true
    gradient is 0 and each path holds ~1e-8 of rounding noise there, which
    AdamW's first step turns into ±lr moves of either sign (on an H100 the
    two paths' noise differs: those biases end 2.6e-4 apart after one AdamW
    step at lr 1e-3)."""
    import torch

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.models import automoe_pooled_features
    from automoe_tpu_torch.train.feature_cache import pooled_keys
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import gating_workload

    cfg = default_model_config()
    H = cfg.policy.num_waypoints
    rng = np.random.default_rng(SEED + 15)
    batch = {"image": rng.normal(size=(8, 256, 256, 3)), "speed": rng.uniform(0, 40, (8, H)),
             "steering": rng.normal(0, 0.2, (8, H)), "throttle": rng.uniform(0, 1, (8, H)),
             "brake": (rng.uniform(0, 1, (8, H)) < 0.1) * 1.0,
             "waypoints": rng.normal(0, 5, (8, H, 2))}
    batch = {k: torch.from_numpy(v.astype(np.float32)).cuda() for k, v in batch.items()}
    runs = {}
    for name, kw in (("experts_eval", dict(experts_eval=True)),
                     ("cached", dict(cache_features=True))):
        wl = gating_workload(cfg, **kw)
        model = wl.init_model(SEED, torch.device("cuda"))
        start = {k: v.clone() for k, v in model.state_dict().items()}
        b = dict(batch)
        if name == "cached":
            b.update(zip(pooled_keys(len(cfg.experts)), automoe_pooled_features(model, b)))
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-2, weight_decay=0.0,
                             total_steps=10, optimizer="sgd",
                             trainable_mask=wl.trainable_mask(model))
        loss = float(make_train_step(wl.loss_fn)(model, opt, b, (SEED + 1, 0))["loss"])
        runs[name] = (loss, model.state_dict(), start)
    (l_ee, sd_ee, start), (l_c, sd_c, _) = runs["experts_eval"], runs["cached"]
    np.testing.assert_allclose(l_c, l_ee, rtol=1e-5)
    worst, frozen = 0.0, 0
    for k, v in sd_c.items():
        if k.startswith("experts."):
            assert torch.equal(v, start[k]) and torch.equal(sd_ee[k], start[k]), k
            frozen += 1
        elif v.is_floating_point():
            np.testing.assert_allclose(v.cpu().numpy(), sd_ee[k].cpu().numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=k)
            worst = max(worst, float((v - sd_ee[k]).abs().max()))
    out = dict(loss_experts_eval=l_ee, loss_cached=l_c, max_trained_abs_diff=worst,
               frozen_tensors_bit_equal=frozen)
    print(f"phase 15d cached step vs experts_eval step: {out}", flush=True)
    return out


#: card against CPU in phase 16 (TF32 off): the float evals' losses and
#: metrics (a near-tie match that forks moves a loss by less), and the int8
#: ones, whose trunks turn the kernels' rounding flips into drift: held as
#: phase 6 holds the int8 engine (3% of a value, 0.05 on an expert weight)
EVAL_RTOL, EVAL_ATOL = 1e-3, 1e-3
EVAL_INT8_RTOL, EVAL_INT8_ATOL = 0.03, 0.05


def eval_cli_run(argv, out_dir: Path, device: str):
    """One `automoe-eval-torch` run with every kernel's launches counted
    from 0: (result, {kernel: launches})."""
    from automoe_tpu_torch.evals.cli import main as eval_main
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.ops import stem

    ak.reset_launch_counts()
    stem.reset_launch_counts()
    res = eval_main(argv + ["--device", device, "--out-dir", str(out_dir)])
    return res, {**ak.LAUNCHES, **stem.LAUNCHES}


def close_json(got, want, rtol: float, atol: float, path: str = "") -> float:
    """Assert two eval results agree (numbers at rtol / atol, the rest
    equal); returns the largest absolute difference."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        return max([close_json(got[k], want[k], rtol, atol, f"{path}/{k}") for k in want] or [0])
    if isinstance(want, list):
        assert len(got) == len(want), (path, len(got), len(want))
        return max([close_json(g, w, rtol, atol, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] or [0])
    if isinstance(want, bool) or not isinstance(want, (int, float)):
        assert got == want, (path, got, want)
        return 0.0
    assert np.isfinite(got) and abs(got - want) <= atol + rtol * abs(want), (path, got, want)
    return abs(got - want)


def phase_eval_cli(tmp: Path, det_best: Path, gating_best: Path, det_run: Path,
                   other_tmp: Path, frames, speeds):
    """16: `automoe-eval-torch` on the card at the CLI's widths (256x256,
    batch 32, ResNet-18 experts, the default gating config) on synthetic
    CARLA frames, each run held against the same command with --device cpu,
    TF32 off; then `automoe-serve-torch --quantize --fp32`."""
    from automoe_tpu_torch.tools.synth import synth_carla_detection, synth_carla_sequence

    det = synth_carla_detection(tmp / "det", n_per_split={"val": 64}, size=256, max_boxes=20,
                                seed=SEED + 16)
    # 2 runs of 42 frames: 64 windows at horizon 10, 2 batches of 32
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"val": 84}, runs=2, size=256,
                               seed=SEED + 16)
    nus_best = next((other_tmp / "ck" / "nuscenes").glob("*/best.pt"))
    drv_best = next((other_tmp / "ck" / "bdd_drivable").glob("*/best.pt"))
    det_cmd = ["--source", "carla", "--data-root", str(det), "--checkpoint", str(det_best)]
    # name: (argv, int8?, {kernel: launches on the card})
    cases = {
        "bdd detection": (["bdd", "--task", "detection", *det_cmd], False,
                          {"auction_solve": 2}),
        "bdd detection --quantize": (["bdd", "--task", "detection", "--quantize", *det_cmd],
                                     True, {"auction_solve": 2}),
        "bdd drivable": (["bdd", "--task", "drivable", "--source", "carla", "--data-root",
                          str(other_tmp / "cseg"), "--checkpoint", str(drv_best)], False, {}),
        "nuscenes": (["nuscenes", "--data-root", str(other_tmp / "nus"), "--checkpoint",
                      str(nus_best)], False, {"auction_solve": 1}),
        "gating --quantize": (["gating", "--data-root", str(seq), "--checkpoint",
                               str(gating_best), "--quantize"], True,
                              {"s2d_stem_pool_int8_f32": 2}),
        "visualize-detection": (["visualize-detection", *det_cmd], False,
                                {"auction_solve": 1}),
    }
    out = {}
    for name, (argv, int8, want_launches) in cases.items():
        run = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res, launches = eval_cli_run(argv, tmp / name.replace(" ", "_") / device, device)
            run[device] = (res, launches, time.perf_counter() - t0)
        res, launches, seconds = run["cuda"]
        got = {k: v for k, v in launches.items() if v}
        assert got == want_launches, (name, got, want_launches)
        assert not any(run["cpu"][1].values()), (name, run["cpu"][1])
        diff = close_json(res, run["cpu"][0], *((EVAL_INT8_RTOL, EVAL_INT8_ATOL) if int8
                                                 else (EVAL_RTOL, EVAL_ATOL)))
        out[name] = dict(
            result=res if isinstance(res, dict) else {"rows": len(res), "first": res[0]},
            launches=got, max_abs_diff_vs_cpu=diff, seconds_cuda=seconds,
            seconds_cpu=run["cpu"][2])
        print(f"phase 16 {name}: {out[name]}", flush=True)
    vis = sorted(p.name for p in (tmp / "gating_--quantize" / "cuda" / "vis").iterdir())
    assert vis == ["context_corr_pearson.png", "context_corr_spearman.png",
                   "expert_usage.png"], vis
    assert len(list((tmp / "visualize-detection" / "cuda" / "vis").glob("det_*.jpg"))) == 16

    from automoe_tpu_torch.evals.cli import main as eval_main

    curves = eval_main(["training-curves", "--run-dir", str(det_run), "--out",
                        str(tmp / "curves.png")])
    assert curves["tags"] and (tmp / "curves.png").stat().st_size > 0, curves
    out["training-curves"] = curves
    print(f"phase 16 training-curves: {curves}", flush=True)

    n_batches, launches = serve_four(["--quantize", "--fp32"], frames, speeds,
                                     kernel="s2d_stem_pool_int8_f32")
    out["serve --quantize --fp32"] = dict(batches=n_batches, k3_f32_launches=launches)
    print(f"phase 16 serve --quantize --fp32: {out['serve --quantize --fp32']}", flush=True)
    return out


def infer_cli_run(argv, out_dir: Path) -> dict:
    """`automoe-infer-torch` through its entry point on the card, K3's
    launches counted from 0 around it: its summary line, the launches, the
    run's seconds; every step's controls finite and in range, its expert
    weights summing to 1."""
    from automoe_tpu_torch.infer.run_automoe import main as infer_main
    from automoe_tpu_torch.ops import stem

    stem.reset_launch_counts()
    t0 = time.perf_counter()
    summary = infer_main([*argv, "--out-dir", str(out_dir)])
    seconds = time.perf_counter() - t0
    launches = dict(stem.LAUNCHES)
    logs = json.loads((out_dir / "log.json").read_text())
    assert len(logs) == summary["steps"] and np.isfinite(summary["p50_infer_ms"]), summary
    for entry in logs:
        assert np.isfinite([entry["steer"], entry["throttle"], entry["brake"],
                            entry["target_kmh"]]).all(), entry
        assert 0 <= entry["throttle"] <= 1 and -1 <= entry["steer"] <= 1, entry
        np.testing.assert_allclose(sum(entry["expert_weights"]), 1.0, rtol=1e-2)
    return dict(summary, launches=launches, seconds=seconds)


#: the closed loop's control steps through the entry point (phase 17)
LOOP_STEPS = 200


def phase_closed_loop(tmp: Path, gating_best: Path, frames, speeds):
    """17: `automoe-infer-torch` on MockSim and the CARLA stub at full
    width; then the closed loop at f32 and the full-context top-k engine,
    each card against CPU (TF32 off)."""
    import dataclasses

    import torch

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.infer.run_automoe import run_closed_loop
    from automoe_tpu_torch.infer.sim import MockSim

    k3_only = {"s2d_stem_pool_int8_f32": 0, "maxpool3x3s2_int8": 0}
    out = {}
    # name: (argv, K3 launches: one per control step and one for the warm-up)
    cases = {
        "a bf16": (["--steps", str(LOOP_STEPS)], 0),
        "b --quantize": (["--steps", str(LOOP_STEPS), "--quantize"], LOOP_STEPS + 1),
        "c --checkpoint <gating best> --quantize": (
            ["--steps", "50", "--checkpoint", str(gating_best), "--quantize"], 51),
    }
    for name, (argv, k3) in cases.items():
        out[name] = infer_cli_run(["--backend", "mock", *argv], tmp / name.split()[0])
        assert out[name]["launches"] == {"s2d_stem_pool_int8": k3, **k3_only}, (name, out[name])
        print(f"phase 17 {name}: {out[name]}", flush=True)

    # by path: a `tests` package installed elsewhere may shadow the checkout's
    spec = importlib.util.spec_from_file_location(
        "carla_stub", Path(__file__).resolve().parent / "tests" / "carla_stub.py")
    carla_stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(carla_stub)
    had = sys.modules.get("carla")
    carla_stub.install()
    try:
        out["d --backend carla"] = infer_cli_run(
            ["--backend", "carla", "--steps", "10", "--quantize"], tmp / "d")
    finally:
        if had is None:
            del sys.modules["carla"]
        else:
            sys.modules["carla"] = had
    assert out["d --backend carla"]["launches"] == {"s2d_stem_pool_int8": 11, **k3_only}
    print(f"phase 17 d --backend carla: {out['d --backend carla']}", flush=True)

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = default_model_config()
    logs = {d: run_closed_loop(InferenceEngine(cfg, dtype=torch.float32, device=d),
                               MockSim(seed=SEED), steps=12) for d in ("cuda", "cpu")}
    diff = {"controls": 0.0, "expert_weights": 0.0}
    for g, w in zip(logs["cuda"], logs["cpu"]):
        for k in ("steer", "throttle", "brake", "speed_kmh"):
            assert abs(g[k] - w[k]) <= 1e-4, (g["step"], k, g[k], w[k])
            diff["controls"] = max(diff["controls"], abs(g[k] - w[k]))
        ew = float(np.abs(np.subtract(g["expert_weights"], w["expert_weights"])).max())
        assert ew <= 1e-5, (g["step"], ew)
        diff["expert_weights"] = max(diff["expert_weights"], ew)
    out["e f32 card vs cpu, 12 steps"] = dict(
        max_abs_diff=diff, final_speed_kmh=logs["cuda"][-1]["speed_kmh"],
        p50_infer_ms=float(np.median([e["infer_ms"] for e in logs["cuda"][5:]])),
        p50_infer_ms_cpu=float(np.median([e["infer_ms"] for e in logs["cpu"][5:]])))
    print(f"phase 17 e: {out['e f32 card vs cpu, 12 steps']}", flush=True)

    full = dataclasses.replace(
        cfg, context=dataclasses.replace(cfg.context, type="full"),
        gating=dataclasses.replace(cfg.gating, honor_topk_in_composite=True))
    assert full.gating.top_k == 2 and full.gating.apply_topk_at_eval
    engines = {d: InferenceEngine(full, dtype=torch.float32, device=d) for d in ("cuda", "cpu")}
    res = {d: e.infer_batch(frames, speeds) for d, e in engines.items()}
    for k in res["cpu"]:
        np.testing.assert_allclose(res["cuda"][k], res["cpu"][k], rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    chosen = (res["cuda"]["expert_weights"] > 0).sum(-1)
    assert (chosen == 2).all(), chosen
    out["f full context, top-2 at eval, B=8"] = dict(
        step_ms=step_ms(engines["cuda"], frames, speeds), experts_chosen=chosen.tolist(),
        max_abs_diff_vs_cpu={k: float(np.abs(res["cuda"][k] - res["cpu"][k]).max())
                             for k in res["cpu"]})
    print(f"phase 17 f: {out['f full context, top-2 at eval, B=8']}", flush=True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return out


#: the bundles of phase 18: name → (InferenceEngine options, the stem kernel its
#: program launches, the outputs' tolerance against the live engine)
BUNDLES = {
    "bf16": ({}, None, "bf16"),
    "int8": ({"quantize": True}, "s2d_stem_pool_int8", "bf16"),
    "int8 --fp32": ({"quantize": True, "dtype": "float32"}, "s2d_stem_pool_int8_f32", "f32"),
    "int8 pool stem": ({"quantize": True, "stem_variant": "pool"}, "maxpool3x3s2_int8", "bf16"),
}
#: a bundle runs the live engine's aten ops and kernels on the same inputs, so
#: its outputs should be equal; an f32 engine's are held within f32 round-off,
#: a bf16 engine's within one bf16 rounding step (2^-8) of their scale, which
#: another cuDNN or cuBLAS algorithm for the same call could give
BUNDLE_TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=1e-2, atol=1e-2)}

#: 18c: the int8 engine built live, and its bundle loaded, each in a fresh
#: process: {stage: seconds from the process's start}, the waypoints of B=8
COLD_LIVE = """
import time; t0 = time.perf_counter()
import json, sys, numpy as np, torch
from automoe_tpu_torch.configs import default_model_config
from automoe_tpu_torch.infer import InferenceEngine
frames, speeds, calib = (np.load(sys.argv[1] + n) for n in ("/frames.npy", "/speeds.npy", "/calib.npy"))
torch.cuda.init(); t1 = time.perf_counter()
eng = InferenceEngine(default_model_config(), device="cuda", quantize=True, calib_frames=calib)
torch.cuda.synchronize(); t2 = time.perf_counter()
out = eng.infer_batch(frames, speeds); t3 = time.perf_counter()
print(json.dumps({"imports_and_cuda_init_s": t1 - t0, "build_s": t2 - t1, "first_batch_s": t3 - t2,
                  "total_s": t3 - t0, "waypoints": out["waypoints"].tolist()}))
"""
COLD_BUNDLE = """
import time; t0 = time.perf_counter()
import json, sys, numpy as np, torch
from automoe_tpu_torch.serving.export import ArtifactEngine
frames, speeds = (np.load(sys.argv[1] + n) for n in ("/frames.npy", "/speeds.npy"))
torch.cuda.init(); t1 = time.perf_counter()
art = ArtifactEngine(sys.argv[2]); t2 = time.perf_counter()
out = art.infer_batch(frames, speeds); t3 = time.perf_counter()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "automoe_tpu")
       or m.startswith(("automoe_tpu_torch.models", "automoe_tpu_torch.infer",
                        "automoe_tpu_torch.serving.quant"))]
assert not bad, bad
print(json.dumps({"imports_and_cuda_init_s": t1 - t0, "load_s": t2 - t1, "first_batch_s": t3 - t2,
                  "total_s": t3 - t0, "waypoints": out["waypoints"].tolist()}))
"""


def fresh_process(code: str, *args) -> dict:
    """`code` in a new python process from the checkout; its last line of
    output is JSON."""
    res = subprocess.run([sys.executable, "-c", code, *map(str, args)], capture_output=True,
                         text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase_bundles(tmp: Path, frames, speeds, calib, smi: str):
    """18: (a) a bundle (buckets 1 and 8) of each engine of BUNDLES, loaded
    through ArtifactEngine and held against the live engine at B=8 and B=1,
    its stem kernel launched once per bundle batch; (b) automoe-serve-torch
    --bundle; (c) cold start in fresh processes."""
    import torch

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.serving.cli import main as serve_main
    from automoe_tpu_torch.serving.export import ArtifactEngine, save_serving_bundle

    cfg = default_model_config()
    out = {"card": smi}
    for name, (kw, kernel, tol) in BUNDLES.items():
        kw = {k: getattr(torch, v) if k == "dtype" else v for k, v in kw.items()}
        t0 = time.perf_counter()
        eng = InferenceEngine(cfg, device="cuda", calib_frames=calib, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        want = {8: eng.infer_batch(frames, speeds), 1: eng.infer_batch(frames[:1], speeds[:1])}
        live_ms = step_ms(eng, frames, speeds)
        d = tmp / name.replace(" ", "_")
        t0 = time.perf_counter()
        save_serving_bundle(eng, d, buckets=(1, 8))
        export_s = time.perf_counter() - t0
        del eng
        t0 = time.perf_counter()
        art = ArtifactEngine(d)
        load_s = time.perf_counter() - t0
        stem.reset_launch_counts()
        t0 = time.perf_counter()
        got = {8: art.infer_batch(frames, speeds)}
        first_s = time.perf_counter() - t0
        got[1] = art.infer_batch(frames[:1], speeds[:1])
        counts = dict(stem.LAUNCHES)
        launches = counts.pop(kernel) if kernel else 0
        assert launches == (2 if kernel else 0) and not any(counts.values()), (name, counts)
        err = {}
        for b in (8, 1):
            check_outputs(got[b], b, cfg)
            for k, v in want[b].items():
                np.testing.assert_allclose(got[b][k], v, **BUNDLE_TOL[tol], err_msg=f"{name} {k}")
                err[k] = max(err.get(k, 0.0), float(np.abs(got[b][k] - v).max()))
        out[name] = dict(kernel=kernel, launches=launches, max_abs_err=err, tolerance=tol,
                         live_build_s=build_s, export_s=export_s, load_s=load_s,
                         first_batch_s=first_s, bundle_mb=sum(
                             f.stat().st_size for f in d.iterdir()) / 2**20,
                         bundle_step_ms_b8=step_ms(art, frames, speeds), live_step_ms_b8=live_ms)
        print(f"phase 18a {name}: {out[name]}", flush=True)
        del art
        torch.cuda.empty_cache()

    # (b) the int8 bundle behind the TCP server; --ema is refused
    int8 = tmp / "int8"
    n_batches, k3 = serve_four(["--bundle", str(int8)], frames, speeds)
    try:
        serve_main(["--bundle", str(int8), "--ema", "--port", "0"], block=False)
        raise AssertionError("--bundle --ema served")
    except SystemExit as e:
        assert e.code not in (0, None), e.code
    out["serve --bundle"] = {"batches": n_batches, "k3_launches": k3, "buckets": [1, 8]}
    print(f"phase 18b serve --bundle: {out['serve --bundle']}", flush=True)

    # (c) cold start: the live int8 engine (calibration included) against its
    # bundle, each from a fresh process
    for n, a in (("frames", frames), ("speeds", speeds), ("calib", calib)):
        np.save(tmp / f"{n}.npy", a)
    live = fresh_process(COLD_LIVE, tmp)
    cold = fresh_process(COLD_BUNDLE, tmp, int8)
    np.testing.assert_allclose(cold.pop("waypoints"), live.pop("waypoints"),
                               **BUNDLE_TOL["bf16"])
    out["cold start, int8"] = {"live engine": live, "bundle": cold}
    print(f"phase 18c cold start ({smi}): {out['cold start, int8']}", flush=True)
    return out


def custom_op_host_us(stem, gen, calls: int = 100) -> dict:
    """18e: host microseconds a call of K3 (bf16, B=8) and K4 (B=8) through
    their torch.library ops against the ops' CUDA bodies called directly
    (the same checks and launch, no dispatcher): the median over `calls`
    calls of each, host clock around the call (the launch is asynchronous),
    in four interleaved blocks (op, direct, direct, op)."""
    import torch

    args = stem_inputs(B_MAIN, gen)
    x = torch.randint(0, 128, (B_MAIN, 128, 128, 256), device="cuda", dtype=torch.int8,
                      generator=gen)
    cases = {
        "s2d_stem_pool_int8": (
            lambda: torch.ops.automoe.s2d_stem_pool_int8(*args),
            lambda: stem._stem_launch("automoe_stem_s2d_pool_int8", "s2d_stem_pool_int8",
                                      torch.bfloat16, *args)),
        "maxpool3x3s2_int8": (lambda: torch.ops.automoe.maxpool3x3s2_int8(x),
                              lambda: stem._maxpool3x3s2_int8_launch(x)),
    }
    out = {}
    for name, (op, direct) in cases.items():
        times = {"op": [], "direct": []}
        for kind in ("op", "direct", "direct", "op"):
            fn = op if kind == "op" else direct
            fn()
            torch.cuda.synchronize()
            for _ in range(calls):
                t0 = time.perf_counter()
                fn()
                times[kind].append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
        out[name] = {k: float(np.median(v)) for k, v in times.items()}
    print(f"phase 18e custom op host cost, us a call: {out}", flush=True)
    return out


def phase_fused(smi: str):
    """18d: FusedAutoMoE against AutoMoE on the same fused weights at the
    default config, 256x256, B=8: f32 with TF32 off (rtol 1e-4 / atol 1e-5:
    the grouped and the separate convs sum in another order), then bf16
    (phase 6's low-precision bound: waypoints within 3% mean relative
    error, expert weights within 0.05); each forward's time from CUDA
    events (mean of 10 after 3 warm-ups)."""
    import torch

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.models import create_automoe_model
    from automoe_tpu_torch.models.fused_experts import (
        create_fused_automoe_model,
        fuse_automoe_state_dict,
    )

    cfg = default_model_config()
    model = create_automoe_model(cfg, device="cuda", seed=SEED)
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():  # running statistics away from their identity init
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    fused = create_fused_automoe_model(cfg, fuse_automoe_state_dict(model.state_dict(), cfg),
                                       device="cuda")
    rng = np.random.default_rng(SEED + 18)
    image = torch.from_numpy(rng.normal(size=(B_MAIN, 256, 256, 3)).astype(np.float32))
    speed = torch.from_numpy(rng.uniform(0, 30, (B_MAIN, 1)).astype(np.float32))
    keys = ("waypoints", "speed_seq", "expert_weights", "combined_features", "gate_logits")
    out = {"card": smi, "batch": B_MAIN}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in (torch.float32, torch.bfloat16):
            model, fused = model.to(dtype), fused.to(dtype)
            batch = {"image": image.to("cuda", dtype), "speed": speed.to("cuda", dtype)}
            with torch.no_grad():
                a, b = model(batch), fused(batch)
                ms = {"automoe_ms": cuda_ms(lambda: model(batch), iters=10),
                      "fused_ms": cuda_ms(lambda: fused(batch), iters=10)}
            a = {k: a[k].float().cpu().numpy() for k in keys}
            b = {k: b[k].float().cpu().numpy() for k in keys}
            err = {k: float(np.abs(a[k] - b[k]).max()) for k in keys}
            if dtype == torch.float32:
                for k in keys:
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5, err_msg=k)
            else:
                wp = rel_err(a["waypoints"], b["waypoints"])
                assert wp < 0.03 and err["expert_weights"] < 0.05, (wp, err)
                err["waypoints_rel"] = wp
            out[str(dtype).split(".")[-1]] = dict(ms, max_abs_err=err)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(f"phase 18d FusedAutoMoE vs AutoMoE: {out}", flush=True)
    return out


def phase_deep_policy_step():
    """19a: one AdamW step of the deep policy (depth 4, width 32, 64x64,
    B=4, context 8) on the card and on the CPU from one seed's weights,
    TF32 off: loss within rtol 1e-4; parameters within rtol 1e-3 / atol
    1e-5 (the CPU test's tolerance against JAX) wherever the CPU's
    gradient is 0 or at least 1e-6. AdamW's first step is ~lr·g/(|g| + 1e-8),
    so an element whose gradient is rounding noise (|g| ~ 1e-8) moves by
    an undetermined fraction of lr on each device: those elements are
    held within lr and counted."""
    import torch

    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import policy_workload

    rng = np.random.default_rng(SEED)
    batch = {"image": rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
             "waypoints": (rng.normal(size=(4, 8, 2)) * 3).astype(np.float32),
             "speed": rng.uniform(0, 30, (4, 8)).astype(np.float32),
             "context": rng.uniform(0, 1, (4, 8)).astype(np.float32)}
    lr = 1e-3
    wl = policy_workload(horizon=8, context_dim=8, trunk_depth=4, trunk_width=32)
    step = make_train_step(wl.loss_fn)
    model = wl.init_model(SEED, torch.device("cpu"))
    wl.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, True)[0].backward()
    grad = {k: p.grad.abs() for k, p in model.named_parameters()}
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(SEED, torch.device(dev))
        opt = make_optimizer(model.named_parameters(), learning_rate=lr, weight_decay=1e-4,
                             total_steps=1, optimizer="adamw")
        loss = float(step(model, opt, {k: torch.from_numpy(v).to(dev)
                                       for k, v in batch.items()})["loss"])
        runs[dev] = loss, {k: v.detach().cpu() for k, v in model.state_dict().items()}
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    worst, worst_noise, noise = 0.0, 0.0, 0
    for k, v in runs["cpu"][1].items():
        got, want = runs["cuda"][1][k].numpy(), v.numpy()
        held = ((grad[k] == 0) | (grad[k] >= 1e-6)).numpy()
        np.testing.assert_allclose(got[held], want[held], rtol=1e-3, atol=1e-5, err_msg=k)
        diff = np.abs(got - want)
        assert diff[~held].max(initial=0.0) <= lr, k
        worst = max(worst, float(diff[held].max(initial=0.0)))
        worst_noise = max(worst_noise, float(diff[~held].max(initial=0.0)))
        noise += int((~held).sum())
    out = {"loss_cuda": runs["cuda"][0], "loss_cpu": runs["cpu"][0],
           "max_param_abs_diff": worst, "noise_gradient_elements": noise,
           "max_param_abs_diff_noise_gradient": worst_noise}
    print(f"phase 19a deep policy AdamW step, card vs CPU: {out}", flush=True)
    return out


def phase_deep_policy_cli(tmp: Path, smi: str):
    """19b-c: `automoe-train-torch policy --trunk-depth 16 --trunk-width
    128` at 256x256, B=32, 2 epochs, then --resume full for a third; the
    train step's time and the trunk's achieved FLOP/s against the card's
    dense TF32 peak (PyTorch's default precision runs the convs in TF32);
    then 2 epochs with --bf16, against the dense bf16 peak."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.models.deep_policy import trunk_flops_per_sample
    from automoe_tpu_torch.tools.synth import synth_carla_sequence
    from automoe_tpu_torch.train.cli import main as train_main

    # 2 runs of 74 frames: 132 windows of horizon 8, 4 steps at batch 32
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"train": 148, "val": 26}, runs=2,
                               size=256, seed=SEED)
    argv = ["policy", "--data-root", str(seq), "--image-size", "256", "--batch-size", "32",
            "--trunk-depth", "16", "--trunk-width", "128", "--ckpt-root", str(tmp / "ck"),
            "--runs-root", str(tmp / "runs"), "--run-name", "deep"]
    res = train_main(argv + ["--epochs", "2"])
    resumed = train_main(argv + ["--epochs", "3", "--resume", "full"])
    ck = tmp / "ck" / "carla_policy" / "deep"
    assert (ck / "best.pt").is_file()
    last = load_checkpoint(ck / "last.pt")
    assert last["epoch"] == 2, last["epoch"]
    assert tuple(last["model_state_dict"]["pipeline_blocks.conv1"].shape) == (16, 128, 128, 3,
                                                                             3)
    losses, vals = metrics_of(tmp / "runs" / "carla_policy_deep")
    assert len(losses) == len(vals) == 3 and np.isfinite(losses + vals).all(), (losses, vals)
    # the same trainer in bf16 (autocast: bf16 convs, GroupNorm in float32)
    bf16 = train_main([a if a != "deep" else "deep-bf16" for a in argv]
                      + ["--epochs", "2", "--bf16"])
    losses16, vals16 = metrics_of(tmp / "runs" / "carla_policy_deep-bf16")
    assert len(vals16) == 2 and np.isfinite(losses16 + vals16).all(), (losses16, vals16)
    flops = trunk_flops_per_sample(16, 128, 256 // 4) * 3 * 32  # forward + backward
    tflops = flops / (res["step_ms_p50"] * 1e-3) / 1e12
    tflops16 = flops / (bf16["step_ms_p50"] * 1e-3) / 1e12
    out = {"batch": 32, "train_loss_epoch": losses, "val_loss": vals,
           "train/step_ms_p50": res["step_ms_p50"], "train/step_ms_mean": res["step_ms_mean"],
           "timed_steps": res["timed_steps"],
           "resumed_step_ms_p50": resumed["step_ms_p50"],
           "trunk_flops_per_step": flops, "trunk_tflops_per_s": tflops,
           "dense_tf32_peak_tflops_per_s": PEAK_TF32_FLOPS / 1e12,
           "trunk_share_of_tf32_peak": tflops * 1e12 / PEAK_TF32_FLOPS,
           "bf16": {"train/step_ms_p50": bf16["step_ms_p50"], "val_loss": vals16,
                    "trunk_tflops_per_s": tflops16,
                    "dense_bf16_peak_tflops_per_s": PEAK_BF16_FLOPS / 1e12,
                    "trunk_share_of_bf16_peak": tflops16 * 1e12 / PEAK_BF16_FLOPS},
           "card": smi}
    print(f"phase 19b-c deep policy CLI ({smi}): {out}", flush=True)
    return out


#: the staged program's counts on the card: cut from the runner's defaults
#: only as far as time asks; the image size and the model widths are its own
CAMPAIGN_ARGV = ["--image-size", "256", "--bdd-train", "64", "--bdd-val", "16",
                 "--carla-runs", "3", "--carla-frames", "32", "--epochs-experts", "1",
                 "--epochs-finetune", "1", "--epochs-policy", "1", "--epochs-gating", "1",
                 "--serve-seconds", "5", "--loop-steps", "20"]

SUPERVISED_CHILD = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from automoe_tpu_torch.train.cli import main
state, argv = Path(sys.argv[2]), sys.argv[3:]
if not state.exists():
    state.write_text("crashed")
    main(argv + ["--epochs", "1"])  # stops after one of the epochs, as a crash would
    sys.exit(1)
main(argv)
"""


def phase_campaign(tmp: Path, smi: str):
    """20: (a) the staged program `python -m automoe_tpu_torch.tools.campaign`
    at 256x256, full width, with the kernels' counts reset just before it;
    (b) its eight stages, finite losses, K1, K2 and K3 launched, the closed
    loop finite; (c) `automoe-launch-torch policy-gating` with SKIP_GATING
    on its CARLA caches; (d) `automoe-supervise-torch` around a trainer
    that exits non-zero once; (e) `checks cuda`."""
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.ops import stem as stem_mod
    from automoe_tpu_torch.tools.campaign import STAGES
    from automoe_tpu_torch.tools.campaign import main as campaign_main
    from automoe_tpu_torch.tools.checks import check_cuda

    out = {}
    camp = tmp / "campaign"
    ak.reset_launch_counts()
    stem_mod.reset_launch_counts()
    t0 = time.perf_counter()
    rec = campaign_main(CAMPAIGN_ARGV + ["--out", str(camp)])
    wall = time.perf_counter() - t0
    launches = {"auction_solve": ak.LAUNCHES["auction_solve"], **stem_mod.LAUNCHES}
    assert rec["order"] == list(STAGES), rec["order"]
    st = rec["stages"]
    losses = ([st["experts"][t]["best_val_loss"] for t in ("detection", "drivable",
                                                           "segmentation")]
              + [st["finetune"][t]["best_val_loss"] for t in ("detection", "segmentation",
                                                               "drivable", "nuscenes_2d")]
              + [st[s]["best_val_loss"] for s in ("policy", "gating")])
    assert np.isfinite(losses).all(), losses
    k1 = {f"{s} {t}": st[s][t]["kernel_launches"].get("auction_solve", 0)
          for s in ("experts", "finetune") for t in ("detection",)}
    k2 = st["finetune"]["nuscenes_2d"]["kernel_launches"].get("auction_solve", 0)
    k3 = st["export"]["kernel_launches"].get("s2d_stem_pool_int8", 0)
    assert all(v > 0 for v in k1.values()) and k2 > 0 and k3 > 0, (k1, k2, k3)
    assert launches["auction_solve"] == sum(k1.values()) + k2, (launches, k1, k2)
    assert launches["s2d_stem_pool_int8"] == k3, (launches, k3)
    assert st["serve"]["closed_loop_finite"] is True and st["serve"]["closed_loop_steps"] == 20
    sv = st["serve"]
    assert sv["serve_errors"] == 0 and sv["batches"] >= 1 and sv["achieved_rps"] > 0, sv
    controls = st["export"]["int8_vs_bf16_max_abs_controls"]
    assert np.isfinite(list(controls.values())).all(), controls
    out["a-b campaign"] = {
        "argv": CAMPAIGN_ARGV, "wall_s": wall, "launches": launches,
        "k1_launches": k1, "k2_alone_launches_nuscenes_2d": k2, "k3_launches_export": k3,
        "stage_wall_s": {s: st[s]["wall_s"] for s in STAGES},
        "int8_vs_bf16_max_abs_controls": controls, "serve": st["serve"],
        "best_val_loss": dict(zip(["experts " + t for t in ("detection", "drivable",
                                                             "segmentation")]
                                  + ["finetune " + t for t in ("detection", "segmentation",
                                                               "drivable", "nuscenes_2d")]
                                  + ["policy", "gating"], losses)),
        "eval": st["eval"], "card": smi}
    print(f"phase 20a-b campaign ({smi}): {out['a-b campaign']}", flush=True)

    out.update(phase_launch_supervise(tmp, camp / "data" / "carla_pre"))
    rep = check_cuda()
    assert rep["cuda_available"] and rep["n_devices"] >= 1 and rep["matmul_ok"], rep
    out["e checks cuda"] = rep
    print(f"phase 20e checks cuda: {rep}", flush=True)
    return out


def phase_launch_supervise(tmp: Path, pre: Path):
    """20c-d on the staged program's 256x256 CARLA caches `pre`."""
    import os

    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.tools.launch import main as launch_main
    from automoe_tpu_torch.tools.supervisor import main as supervise_main

    out = {}
    os.environ["SKIP_GATING"] = "1"
    try:
        launch_main(["policy-gating", "--epochs", "1", "--batch-size", "16", "--image-size",
                     "256", "--data-root", str(pre), "--ckpt-root", str(tmp / "lck"),
                     "--runs-root", str(tmp / "lruns"), "--log-dir", str(tmp / "logs")])
    finally:
        del os.environ["SKIP_GATING"]
    best = tmp / "lck" / "carla_policy" / "pipeline" / "best.pt"
    assert best.is_file() and not (tmp / "lck" / "gating").exists()
    losses, vals = metrics_of(tmp / "lruns" / "carla_policy_pipeline")
    assert np.isfinite(losses + vals).all()
    out["c launch policy-gating"] = {"train_loss_epoch": losses, "val_loss": vals}
    print(f"phase 20c automoe-launch-torch: {out['c launch policy-gating']}", flush=True)

    runs = tmp / "sruns"
    train = ["policy", "--data-root", str(pre), "--image-size", "256", "--batch-size", "16",
             "--trunk-depth", "2", "--trunk-width", "32", "--epochs", "2", "--run-name", "sup",
             "--ckpt-root", str(tmp / "sck"), "--runs-root", str(runs)]
    events = tmp / "events.jsonl"
    rc = supervise_main(["--max-restarts", "2", "--backoff", "0.1", "--resume-args",
                         "--resume full", "--heartbeat", str(runs / "carla_policy_sup" /
                                                            "metrics.jsonl"),
                         "--heartbeat-timeout", "300", "--event-log", str(events), "--",
                         sys.executable, "-c", SUPERVISED_CHILD,
                         str(Path(__file__).resolve().parent), str(tmp / "crashed"), *train])
    kinds = [json.loads(line)["event"] for line in events.read_text().splitlines()]
    last = load_checkpoint(tmp / "sck" / "carla_policy" / "sup" / "last.pt")
    losses, vals = metrics_of(runs / "carla_policy_sup")
    assert rc == 0 and kinds == ["launch", "failure", "launch", "success"], (rc, kinds)
    assert last["epoch"] == 1 and len(vals) == 2 and np.isfinite(losses + vals).all()
    out["d supervise"] = {"events": kinds, "last_epoch": last["epoch"], "val_loss": vals}
    print(f"phase 20d automoe-supervise-torch: {out['d supervise']}", flush=True)
    return out


#: a rank of a phase-21/22 run: automoe-train-torch with its argv (JSON) and
#: the mesh flags, TF32 off, a step's metrics logged every step; prints its
#: result, its kernel launches (counted from 0), its peak device memory and
#: the seconds of each resident epoch's exchange as JSON, last. In its
#: environment SMOKE_NO_DROPOUT=1 turns dropout off (a data rank draws its
#: masks from its data index, so only a dropout-free run of several ranks
#: equals one process) and SMOKE_FLAT_SHARDS=n makes one process's
#: resident loader stage the flat epoch n data ranks assemble;
#: SMOKE_OPTIMIZER=sgd trains with SGD in place of the CLI's AdamW.
RANK_CODE = r"""
import dataclasses, json, os, sys, time
import torch
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
from automoe_tpu_torch.data import device_resident as dr
from automoe_tpu_torch.ops import auction_kernel as ak, stem
from automoe_tpu_torch.train import cli
if os.environ.get("SMOKE_NO_DROPOUT") == "1":
    torch.nn.Dropout.forward = lambda self, x: x
shards = int(os.environ.get("SMOKE_FLAT_SHARDS", "0"))
from_dataset = dr.DeviceEpochLoader.from_dataset.__func__
def flat(cls, dataset, *, indices=None, batch_size, group_size=1, **kw):
    per = batch_size // shards * max(1, group_size)
    n = len(range(shards - 1, len(dataset), shards)) // per * per
    idx = [i for d in range(shards) for i in list(range(d, len(dataset), shards))[:n]]
    return from_dataset(cls, dataset, indices=idx, batch_size=batch_size,
                        group_size=group_size, **kw)
if shards:
    dr.DeviceEpochLoader.from_dataset = classmethod(flat)
rows, exchange_s, cuda = dr.DeviceEpochLoader._rows, [], torch.cuda.is_available()
def timed_rows(self, perm):
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rows(self, perm)
    if cuda:
        torch.cuda.synchronize()
    exchange_s.append(time.perf_counter() - t0)
    return out
dr.DeviceEpochLoader._rows = timed_rows
base = cli._train_cfg
opt = os.environ.get("SMOKE_OPTIMIZER")  # e.g. sgd: the CLI always trains with AdamW
cli._train_cfg = lambda args, pipeline="": dataclasses.replace(
    base(args, pipeline), log_every=1, **({"optimizer": opt} if opt else {}))
mesh_of, seen = cli._mesh, {}
def _mesh(args, **kw):
    mesh = mesh_of(args, **kw)
    if mesh is not None:
        seen.update(backend=mesh.backend, staging=mesh.staging_label)
    return mesh
cli._mesh = _mesh
ak.reset_launch_counts()
stem.reset_launch_counts()
res = cli.main(json.loads(sys.argv[1]))
print(json.dumps({"result": res, **seen, "launches": {"auction_solve": ak.LAUNCHES["auction_solve"],
                                                      **stem.LAUNCHES},
                  "peak_mib": torch.cuda.max_memory_allocated() / 2**20 if cuda else None,
                  "resident_exchange_s": exchange_s}))
"""
RANK_TIMEOUT_S = 600


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cli_ranks(argv, world: int, env=None, mesh: bool = True) -> list:
    """`automoe-train-torch argv` as `world` processes of one world on this
    card (--multihost on a free localhost port), each with its own timeout:
    a rank that fails or hangs fails the phase. Each rank's JSON line.
    env: added to each process's environment (RANK_CODE's switches);
    mesh=False runs one process with argv as given."""
    import os

    coord = f"127.0.0.1:{free_port()}"
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root), **(env or {})}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, json.dumps(
            argv + (["--multihost", "--coordinator", coord, "--num-processes", str(world),
                     "--process-id", str(r)] if mesh else []))],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs, failed = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            failed = True
            p.kill()
            outs.append(p.communicate())
        failed = failed or p.returncode != 0
    if failed:
        for p in procs:
            p.kill()
        raise AssertionError("a rank failed: " + " | ".join(
            f"rank {r} exit {p.returncode}: {o[1][-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [json.loads(o[0].strip().splitlines()[-1]) for o in outs]


def backend_of(ranks, backend: str = "gloo", staging: str = "host") -> dict:
    """The backend and staging every rank saw, checked against those
    expected (gloo through host memory when the ranks share a card)."""
    seen = {(r["backend"], r["staging"]) for r in ranks}
    assert seen == {(backend, staging)}, seen
    return {"backend": backend, "staging": staging}


def in_process_cli(argv) -> dict:
    """The same as a rank of cli_ranks, in this process (TF32 as the
    caller set it)."""
    import dataclasses

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.train import cli

    base = cli._train_cfg
    cli._train_cfg = lambda args, pipeline="": dataclasses.replace(base(args, pipeline),
                                                                   log_every=1)
    try:
        ak.reset_launch_counts()
        stem.reset_launch_counts()
        res = cli.main(argv)
    finally:
        cli._train_cfg = base
    return {"result": res, "launches": {"auction_solve": ak.LAUNCHES["auction_solve"],
                                        **stem.LAUNCHES}}


def step_losses(run_dir: Path) -> list:
    return [r["train/loss"] for r in map(json.loads, (run_dir / "metrics.jsonl")
                                         .read_text().splitlines()) if "train/loss" in r]


def held_run(got: dict, want: dict, lr: float, what: str, steps_per_call: int = 1,
             sgd: bool = False, stats: bool = True) -> dict:
    """A run (its `last` checkpoint and per-call losses: one a step, or one
    a call of `steps_per_call` steps) against a reference run, with
    tests/test_torch_port_parallel_dp.py's CLI rule: losses rtol 1e-4,
    parameters rtol 1e-3 / atol 4·lr·steps (AdamW moves a parameter whose
    gradient is rounding noise by up to ~lr a step); sgd=True: parameters
    rtol 1e-4 / atol 1e-5 (no such amplification). BatchNorm's running
    statistics are held as the parameters are, or, with stats=False,
    reported and not held (an AdamW run's statistics follow the
    noise-moved weights: hold them in an SGD run)."""
    from automoe_tpu_torch.ckpt import load_checkpoint

    a, b = load_checkpoint(got["ckpt"]), load_checkpoint(want["ckpt"])
    la, lb = step_losses(got["runs"]), step_losses(want["runs"])
    assert (len(la) * steps_per_call == len(lb) * steps_per_call == a["step"] == b["step"]
            > 0), (what, la, lb)
    np.testing.assert_allclose(la, lb, rtol=1e-4, err_msg=what)
    rtol, atol = (1e-4, 1e-5) if sgd else (1e-3, 4 * lr * a["step"])
    worst, worst_stat = 0.0, 0.0
    for k, v in b["model_state_dict"].items():
        w = a["model_state_dict"][k]
        assert w.shape == v.shape, (what, k, w.shape, v.shape)
        if v.is_floating_point():
            err = float((w - v).abs().max())
            stat = k.endswith(("running_mean", "running_var"))
            if stat:
                worst_stat = max(worst_stat, err)
            else:
                worst = max(worst, err)
            if stats or not stat:
                np.testing.assert_allclose(w.numpy(), v.numpy(), rtol=rtol, atol=atol,
                                           err_msg=f"{what}: {k}")
    loss_err = float(np.max(np.abs(np.subtract(la, lb)) / np.abs(lb)))
    return {"steps": a["step"], "step_losses": la, "max_loss_rel_err": loss_err,
            "max_param_abs_err": worst, "max_bn_stat_abs_err": worst_stat,
            "bn_stats_held": stats, "param_rtol": rtol, "param_atol": atol}


def phase_parallel(tmp: Path, frames, speeds, smi: str):
    """21: the whole-block parallel modes through automoe-train-torch at the
    CLI's widths, TF32 off, each run's kernel launches counted from 0:
    (a) `bdd --task detection` (256x256, box cap 48, batch 32, 1 epoch of
    64 frames) with the default mesh (a group of one: the single-process
    path) in this process, then with --no-mesh, then as a group of one
    over NCCL (--multihost --num-processes 1): the same losses and K1
    launches per step; (b) the same global batch as 2 ranks of 16 rows on
    this card (gloo, host staging), held against (a); (c) `policy
    --trunk-depth 16 --trunk-width 128 --pp-microbatches 4 --model-axis 2`
    (256x256, batch 32) on 2 ranks against --no-mesh; (d) `gating
    --parallelism ep` on 4 ranks (the default 4-expert config, 256x256,
    batch 8) against dense gating in one process, then
    `automoe-serve-torch --checkpoint <its best> --quantize` (K3)."""
    from automoe_tpu_torch.tools.synth import synth_bdd_detection, synth_carla_sequence

    out = {"card": smi}
    det = synth_bdd_detection(tmp / "bdd", n_per_split={"train": 64, "val": 32}, size=256,
                              max_boxes=20, seed=SEED)

    def det_argv(name, batch, *extra):
        return ["bdd", "--task", "detection", "--data-root", str(det), "--image-size", "256",
                "--box-cap", "48", "--batch-size", str(batch), "--epochs", "1",
                "--ckpt-root", str(tmp / name / "ck"), "--runs-root", str(tmp / name / "runs"),
                *extra]

    def det_run(name):
        return {"ckpt": tmp / name / "ck" / "bdd_detection" / "run" / "last.pt",
                "runs": tmp / name / "runs" / "bdd_detection_run"}

    # (a) one process: the default mesh, --no-mesh, an NCCL group of one
    steps_det = 64 // 32 + 32 // 32  # train + val steps, K1 once each
    a = {"default mesh": in_process_cli(det_argv("a_default", 32)),
         "--no-mesh": in_process_cli(det_argv("a_nomesh", 32, "--no-mesh")),
         "NCCL group of one": cli_ranks(det_argv("a_nccl", 32), 1)[0]}
    assert (a["NCCL group of one"]["backend"], a["NCCL group of one"]["staging"]) == (
        "nccl", "none"), a["NCCL group of one"]
    out["a"] = {}
    for name, r in a.items():
        assert r["launches"]["auction_solve"] == steps_det, (name, r["launches"])
        out["a"][name] = {"k1_launches": r["launches"]["auction_solve"],
                          "k1_launches_per_step": r["launches"]["auction_solve"] / steps_det,
                          "step_ms_p50": r["result"]["step_ms_p50"],
                          "step_ms_mean": r["result"]["step_ms_mean"]}
    out["a"]["--no-mesh vs default"] = held_run(det_run("a_nomesh"), det_run("a_default"),
                                                1e-4, "21a --no-mesh")
    out["a"]["NCCL group of one vs default"] = held_run(det_run("a_nccl"),
                                                        det_run("a_default"), 1e-4,
                                                        "21a nccl")
    print(f"phase 21a ({smi}): backend none (default mesh, --no-mesh) and nccl (group of "
          f"one), staging none: {out['a']}", flush=True)

    # (b) the same global batch on 2 ranks sharing this card
    ranks = cli_ranks(det_argv("b", 16), 2)
    for r in ranks:  # 2 train + 1 val steps of 16 rows a rank
        assert r["launches"]["auction_solve"] == steps_det, r["launches"]
    out["b"] = {**backend_of(ranks), "ranks": 2,
                "k1_launches_per_rank": [r["launches"]["auction_solve"] for r in ranks],
                "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in ranks],
                "step_ms_p50_one_rank": a["default mesh"]["result"]["step_ms_p50"],
                "note": "two ranks share one card: no scaling figure",
                **held_run(det_run("b"), det_run("a_default"), 1e-4, "21b")}
    print(f"phase 21b ({smi}): 2 ranks on one card, backend {out['b']['backend']}, staging "
          f"{out['b']['staging']} (two ranks share one card: no scaling figure): {out['b']}",
          flush=True)

    # (c) the deep trunk pipelined over 2 ranks against one process
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"train": 96, "val": 48}, runs=2,
                               size=256, seed=SEED)

    def seq_argv(cmd, name, batch, *extra):
        return [cmd, "--data-root", str(seq), "--image-size", "256", "--batch-size",
                str(batch), "--epochs", "1", "--ckpt-root", str(tmp / name / "ck"),
                "--runs-root", str(tmp / name / "runs"), *extra]

    deep = ("--trunk-depth", "16", "--trunk-width", "128")
    one = in_process_cli(seq_argv("policy", "c_one", 32, *deep, "--no-mesh"))
    pp = cli_ranks(seq_argv("policy", "c_pp", 32, *deep, "--pp-microbatches", "4",
                            "--model-axis", "2"), 2)

    def pol(name):
        return {"ckpt": tmp / name / "ck" / "carla_policy" / "run" / "last.pt",
                "runs": tmp / name / "runs" / "carla_policy_run"}

    out["c"] = {**backend_of(pp), "ranks": 2, "microbatches": 4,
                "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in pp],
                "step_ms_p50_one_rank": one["result"]["step_ms_p50"],
                **held_run(pol("c_pp"), pol("c_one"), 3e-4, "21c")}
    print(f"phase 21c ({smi}): policy --pp-microbatches 4 --model-axis 2 on 2 ranks, "
          f"backend {out['c']['backend']}, staging {out['c']['staging']}: {out['c']}",
          flush=True)

    # (d) expert-parallel gating on 4 ranks against dense gating, then serving
    dense = in_process_cli(seq_argv("gating", "d_dense", 8))
    ep = cli_ranks(seq_argv("gating", "d_ep", 8, "--parallelism", "ep", "--model-axis", "4"),
                   4)

    def gat(name, wl):
        return {"ckpt": tmp / name / "ck" / wl / "run" / "last.pt",
                "runs": tmp / name / "runs" / f"{wl}_run"}

    out["d"] = {**backend_of(ep), "ranks": 4,
                "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in ep],
                "step_ms_p50_dense": dense["result"]["step_ms_p50"],
                **held_run(gat("d_ep", "gating_ep"), gat("d_dense", "gating"), 1e-4, "21d")}
    best = tmp / "d_ep" / "ck" / "gating_ep" / "run" / "best.pt"
    n_batches, k3 = serve_four(["--checkpoint", str(best), "--quantize"], frames, speeds)
    out["d"]["serve"] = {"batches": n_batches, "k3_launches": k3}
    print(f"phase 21d ({smi}): gating --parallelism ep on 4 ranks, backend "
          f"{out['d']['backend']}, staging {out['d']['staging']}; served with --quantize, K3 "
          f"{k3} launches in {n_batches} batches: {out['d']}", flush=True)
    return out


def phase_parallel_cards(tmp: Path, smi: str):
    """`python3 chip_smoke.py --cards`, on a host of 4 cards: phase 21's
    comparisons with one rank a card, so NCCL (TF32 off): `bdd --task
    detection` on 4 data ranks of 8 rows against one process of 32; the
    deep policy pipelined over 2 stages and 2 data rows (16 rows each)
    against --no-mesh at 32; `gating --parallelism ep` on 4 ranks against
    dense gating. Held as phase 21 holds its runs; each rank's step time."""
    import torch

    from automoe_tpu_torch.tools.synth import synth_bdd_detection, synth_carla_sequence

    assert torch.cuda.device_count() >= 4, "--cards needs 4 cards"
    out = {"card": smi, "cards": torch.cuda.device_count()}
    det = synth_bdd_detection(tmp / "bdd", n_per_split={"train": 64, "val": 32}, size=256,
                              max_boxes=20, seed=SEED)
    seq = synth_carla_sequence(tmp / "seq", n_per_split={"train": 96, "val": 48}, runs=2,
                               size=256, seed=SEED)

    def argv(cmd, root, name, batch, *extra):
        return [cmd, "--data-root", str(root), "--image-size", "256", "--batch-size",
                str(batch), "--epochs", "1", "--ckpt-root", str(tmp / name / "ck"),
                "--runs-root", str(tmp / name / "runs"), *extra]

    def run(name, wl):
        return {"ckpt": tmp / name / "ck" / wl / "run" / "last.pt",
                "runs": tmp / name / "runs" / f"{wl}_run"}

    det_kw = ("--task", "detection", "--box-cap", "48")
    deep = ("--trunk-depth", "16", "--trunk-width", "128")
    cases = {  # name: (reference run, rank run), each (dir, argv, workload); lr
        "dp 4 ranks": (("dp_one", argv("bdd", det, "dp_one", 32, *det_kw), "bdd_detection"),
                       ("dp", argv("bdd", det, "dp", 8, *det_kw), "bdd_detection"), 1e-4),
        "pp 2 x dp 2": (("pp_one", argv("policy", seq, "pp_one", 32, *deep, "--no-mesh"),
                         "carla_policy"),
                        ("pp", argv("policy", seq, "pp", 16, *deep, "--pp-microbatches", "4",
                                    "--model-axis", "2"), "carla_policy"), 3e-4),
        "ep 4 ranks": (("ep_one", argv("gating", seq, "ep_one", 8), "gating"),
                       ("ep", argv("gating", seq, "ep", 8, "--parallelism", "ep"),
                        "gating_ep"), 1e-4)}
    for name, ((ref_dir, ref_argv, ref_wl), (dir_, rank_argv, wl), lr) in cases.items():
        one = in_process_cli(ref_argv)
        ranks = cli_ranks(rank_argv, 4)
        out[name] = {**backend_of(ranks, "nccl", "none"), "ranks": 4,
                     "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in ranks],
                     "step_ms_p50_one_process": one["result"]["step_ms_p50"],
                     "k1_launches_per_rank": [r["launches"]["auction_solve"] for r in ranks],
                     **held_run(run(dir_, wl), run(ref_dir, ref_wl), lr, name)}
        print(f"cards, {name} ({smi}): {out[name]}", flush=True)
    return out


def cache_files_equal(got_dir: Path, want_dir: Path) -> dict:
    """Two feature-cache directories: the same fingerprints (file names) and
    arrays within rtol 1e-5 / atol 1e-6. Returns the largest difference."""
    got = sorted(p.name for p in got_dir.glob("pooled_*.npz"))
    want = sorted(p.name for p in want_dir.glob("pooled_*.npz"))
    assert got == want and len(want) == 2, (got, want)  # train and val
    worst = 0.0
    for name in want:
        with np.load(got_dir / name) as a, np.load(want_dir / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for f in b.files:
                np.testing.assert_allclose(a[f], b[f], rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {f}")
                worst = max(worst, float(np.abs(a[f] - b[f]).max()))
    return {"files": want, "max_abs_err": worst}


def replicated_engines(devices, calib_seed: int = 0):
    """The default config's int8 engine (bf16, 256²) on one card and with
    one replica on each of `devices`, on the same seeded weights and
    calibration frames."""
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine

    cfg = default_model_config()
    calib = np.random.default_rng(calib_seed).integers(0, 256, (2, 600, 800, 3),
                                                       dtype=np.uint8)
    plain = InferenceEngine(cfg, quantize=True, calib_frames=calib, device=devices[0])
    dp = InferenceEngine(cfg, quantize=True, calib_frames=calib, devices=devices)
    return plain, dp


def phase_split(tmp: Path, frames, speeds, smi: str):
    """22: the split-tensor modes and the multi-rank pieces through the
    entry points on this card, TF32 off, each run's kernel launches and
    peak device memory read in its own process: (a) `bdd --task detection`
    (256x256, box cap 48, batch 32, 1 epoch of phase 21's 64 frames) with
    --tp-min-dim 256 --model-axis 2 on 2 ranks (gloo) against --no-mesh,
    with AdamW and with SGD; (b) the same with --spatial --model-axis 2;
    (c) `gating
    --cache-expert-features --device-resident --steps-per-call 2` (the
    default config, 256x256, 8 rows a rank) on 2 ranks against one process
    of 16 rows over the same flat epoch, dropout off in both, and `gating
    --cache-expert-features --tp-min-dim 256 --model-axis 2` on 2 ranks,
    its cache against that one process's; (d)
    `automoe-serve-torch --data-parallel --quantize` (one replica a card:
    one here) answering 4 TCP requests, K3 once a server batch, and its
    engine against the plain one. Runs held by `held_run`."""
    import torch

    out = {"card": smi}
    det, seq = tmp / "bdd", tmp / "seq"  # phase 21's caches

    def det_argv(name, *extra):
        return ["bdd", "--task", "detection", "--data-root", str(det), "--image-size", "256",
                "--box-cap", "48", "--batch-size", "32", "--epochs", "1",
                "--ckpt-root", str(tmp / name / "ck"), "--runs-root", str(tmp / name / "runs"),
                *extra]

    def run(name, wl="bdd_detection"):
        return {"ckpt": tmp / name / "ck" / wl / "run" / "last.pt",
                "runs": tmp / name / "runs" / f"{wl}_run"}

    # each mode twice: with the CLI's AdamW (parameters held by 21's rule;
    # BatchNorm's running statistics follow AdamW's noise-moved weights and
    # are reported), and with SGD (every tensor held at rtol 1e-4 / atol 1e-5)
    steps_det = 64 // 32 + 32 // 32  # train + val steps, K1 once each on each rank
    sgd = {"SMOKE_OPTIMIZER": "sgd"}
    ref = cli_ranks(det_argv("s_nomesh", "--no-mesh"), 1, mesh=False)[0]
    cli_ranks(det_argv("s_nomesh_sgd", "--no-mesh"), 1, mesh=False, env=sgd)
    assert ref["launches"]["auction_solve"] == steps_det, ref["launches"]
    out["--no-mesh"] = {"k1_launches": ref["launches"]["auction_solve"],
                        "step_ms_p50": ref["result"]["step_ms_p50"],
                        "peak_mib": ref["peak_mib"]}
    for key, extra in (("a", ("--tp-min-dim", "256", "--model-axis", "2")),
                       ("b", ("--spatial", "--model-axis", "2"))):
        ranks = cli_ranks(det_argv(f"s_{key}", *extra), 2)
        cli_ranks(det_argv(f"s_{key}_sgd", *extra), 2, env=sgd)
        for r in ranks:
            assert r["launches"]["auction_solve"] == steps_det, r["launches"]
        out[key] = {**backend_of(ranks), "ranks": 2, "flags": " ".join(extra),
                    "k1_launches_per_rank": [r["launches"]["auction_solve"] for r in ranks],
                    "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in ranks],
                    "step_ms_p50_no_mesh": ref["result"]["step_ms_p50"],
                    "peak_mib_per_rank": [r["peak_mib"] for r in ranks],
                    "peak_mib_no_mesh": ref["peak_mib"],
                    "note": "two ranks share one card: no scaling figure",
                    "adamw": held_run(run(f"s_{key}"), run("s_nomesh"), 1e-4, f"22{key}",
                                      stats=False),
                    "sgd": held_run(run(f"s_{key}_sgd"), run("s_nomesh_sgd"), 1e-4,
                                    f"22{key} sgd", sgd=True)}
        print(f"phase 22{key} ({smi}): bdd {' '.join(extra)} on 2 ranks of one card, backend "
              f"{out[key]['backend']}, staging {out[key]['staging']}: {out[key]}", flush=True)

    # (c) the feature cache and the resident epoch over 2 data ranks
    def gating_argv(name, batch):
        return ["gating", "--data-root", str(seq), "--image-size", "256", "--batch-size",
                str(batch), "--epochs", "1", "--cache-expert-features", "--device-resident",
                "--steps-per-call", "2", "--feature-cache-dir", str(tmp / name / "cache"),
                "--ckpt-root", str(tmp / name / "ck"), "--runs-root", str(tmp / name / "runs")]

    one = cli_ranks(gating_argv("c_one", 16), 1, mesh=False,
                    env={"SMOKE_NO_DROPOUT": "1", "SMOKE_FLAT_SHARDS": "2"})[0]
    two = cli_ranks(gating_argv("c_two", 8), 2, env={"SMOKE_NO_DROPOUT": "1"})
    out["c"] = {**backend_of(two), "ranks": 2,
                "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in two],
                "step_ms_p50_one_process": one["result"]["step_ms_p50"],
                "peak_mib_per_rank": [r["peak_mib"] for r in two],
                "peak_mib_one_process": one["peak_mib"],
                "resident_exchange_s_per_rank": [r["resident_exchange_s"] for r in two],
                "resident_reshuffle_s_one_process": one["resident_exchange_s"],
                "cache": cache_files_equal(tmp / "c_two" / "cache", tmp / "c_one" / "cache"),
                **held_run(run("c_two", "gating"), run("c_one", "gating"), 1e-4, "22c",
                           steps_per_call=2)}
    print(f"phase 22c ({smi}): gating --cache-expert-features --device-resident on 2 ranks "
          f"of one card, backend {out['c']['backend']}, staging {out['c']['staging']}: "
          f"{out['c']}", flush=True)
    # the cache's pass under tensor parallelism: each expert is called on its
    # own, the nuScenes expert's [196, 256] query table split at 256
    tp_argv = ["gating", "--data-root", str(seq), "--image-size", "256", "--batch-size", "32",
               "--epochs", "1", "--cache-expert-features", "--tp-min-dim", "256",
               "--model-axis", "2", "--feature-cache-dir", str(tmp / "c_tp" / "cache"),
               "--ckpt-root", str(tmp / "c_tp" / "ck"), "--runs-root", str(tmp / "c_tp" / "runs")]
    tp = cli_ranks(tp_argv, 2, env={"SMOKE_NO_DROPOUT": "1"})
    out["c tp"] = {**backend_of(tp), "ranks": 2, "flags": "--tp-min-dim 256 --model-axis 2",
                   "val_loss_per_rank": [r["result"]["best_val_loss"] for r in tp],
                   "cache_vs_one_process": cache_files_equal(tmp / "c_tp" / "cache",
                                                             tmp / "c_one" / "cache")}
    assert all(np.isfinite(out["c tp"]["val_loss_per_rank"])), out["c tp"]
    print(f"phase 22c ({smi}): gating --cache-expert-features --tp-min-dim 256 --model-axis 2 "
          f"on 2 ranks of one card: {out['c tp']}", flush=True)

    # (d) data-parallel serving: the engine, then the server
    plain, dp = replicated_engines([torch.device("cuda", i)
                                    for i in range(torch.cuda.device_count())])
    assert dp.batch_multiple == torch.cuda.device_count() == 1
    a, b = plain.infer_batch(frames[:4], speeds[:4]), dp.infer_batch(frames[:4], speeds[:4])
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    del plain, dp
    n_batches, k3 = serve_four(["--data-parallel", "--quantize"], frames, speeds)
    out["d"] = {"replicas": 1, "batch_multiple": 1, "engine_equal_to_plain": True,
                "batches": n_batches, "k3_launches": k3}
    print(f"phase 22d ({smi}): automoe-serve-torch --data-parallel --quantize, 1 replica, "
          f"K3 {k3} launches in {n_batches} batches: {out['d']}", flush=True)
    return out


def phase_split_cards(tmp: Path, smi: str, frames, speeds):
    """`--cards`, phase 22's modes one rank a card over NCCL (TF32 off):
    `bdd --task detection` with --tp-min-dim 256 at data 2 x model 2 and
    with --spatial at model 2 x data 2 (16 rows a data rank) against one
    process of 32, with AdamW and with SGD as phase 22 holds them;
    `--data-parallel` serving over the 4 cards, a batch of 3 frames padded
    to 4 (K3 once on each replica), against one card."""
    import torch

    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.tools.synth import synth_bdd_detection

    det = synth_bdd_detection(tmp / "bdd22", n_per_split={"train": 64, "val": 32}, size=256,
                              max_boxes=20, seed=SEED)

    def argv(name, batch, *extra):
        return ["bdd", "--task", "detection", "--data-root", str(det), "--image-size", "256",
                "--box-cap", "48", "--batch-size", str(batch), "--epochs", "1",
                "--ckpt-root", str(tmp / name / "ck"), "--runs-root", str(tmp / name / "runs"),
                *extra]

    def run(name):
        return {"ckpt": tmp / name / "ck" / "bdd_detection" / "run" / "last.pt",
                "runs": tmp / name / "runs" / "bdd_detection_run"}

    out = {"card": smi}
    sgd = {"SMOKE_OPTIMIZER": "sgd"}  # as phase 22: AdamW and SGD runs
    one = in_process_cli(argv("s_one", 32, "--no-mesh"))
    cli_ranks(argv("s_one_sgd", 32, "--no-mesh"), 1, mesh=False, env=sgd)
    for name, extra in (("tp data 2 x model 2", ("--tp-min-dim", "256", "--model-axis", "2")),
                        ("sp model 2 x data 2", ("--spatial", "--model-axis", "2"))):
        d = name.split()[0]
        ranks = cli_ranks(argv(f"s_{d}", 16, *extra), 4)
        cli_ranks(argv(f"s_{d}_sgd", 16, *extra), 4, env=sgd)
        out[name] = {**backend_of(ranks, "nccl", "none"), "ranks": 4,
                     "step_ms_p50_per_rank": [r["result"]["step_ms_p50"] for r in ranks],
                     "step_ms_p50_one_process": one["result"]["step_ms_p50"],
                     "peak_mib_per_rank": [r["peak_mib"] for r in ranks],
                     "k1_launches_per_rank": [r["launches"]["auction_solve"] for r in ranks],
                     "adamw": held_run(run(f"s_{d}"), run("s_one"), 1e-4, name, stats=False),
                     "sgd": held_run(run(f"s_{d}_sgd"), run("s_one_sgd"), 1e-4, f"{name} sgd",
                                     sgd=True)}
        print(f"cards, {name} ({smi}): {out[name]}", flush=True)

    plain, dp = replicated_engines([torch.device("cuda", i) for i in range(4)])
    assert dp.batch_multiple == 4
    stem.reset_launch_counts()
    got = dp.infer_batch(frames[:3], speeds[:3])
    k3 = stem.LAUNCHES["s2d_stem_pool_int8"]
    assert k3 == 4, stem.LAUNCHES  # one a replica, the padding row's included
    worst = 0.0
    for i in range(3):  # each replica's rows run at B=1: one card at B=1 is the reference
        want = plain.infer_batch(frames[i:i + 1], speeds[i:i + 1])
        for k in want:
            np.testing.assert_allclose(got[k][i:i + 1], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            worst = max(worst, float(np.abs(got[k][i:i + 1] - want[k]).max()))
    out["serve --data-parallel"] = {"replicas": 4, "batch": 3, "padded_to": 4,
                                    "k3_launches": k3, "max_abs_err_vs_one_card": worst}
    print(f"cards, serve --data-parallel ({smi}): {out['serve --data-parallel']}", flush=True)
    return out


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.abs(a - b).mean() / (np.abs(a).mean() + 1e-12))


def check_outputs(out, B, cfg):
    H = cfg.policy.num_waypoints
    want = {"waypoints": (B, H, 2), "speed": (B, 1), "speed_seq": (B, H),
            "expert_weights": (B, len(cfg.experts))}
    for k, shape in want.items():
        assert out[k].shape == shape, (k, out[k].shape, shape)
        assert np.isfinite(out[k]).all(), k
    np.testing.assert_allclose(out["expert_weights"].sum(-1), 1.0, rtol=1e-2)


def step_ms(engine, frames, speeds, iters: int = 5) -> float:
    engine.infer_batch(frames, speeds)
    t = []
    for _ in range(iters):
        t0 = time.perf_counter()
        engine.infer_batch(frames, speeds)
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--cards" in sys.argv[1:]:
        return main_cards()
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.data import native_packed
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.ops import auction_kernel, stem
    from automoe_tpu_torch.tools.bench_auction import auction_regimes, nuscenes_regimes
    from automoe_tpu_torch.train.workloads import nuscenes_workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # 1. build: both sources start compiling now, each with its own nvcc
    t_build = time.perf_counter()

    def timed_build(build):
        build()
        return time.perf_counter() - t_build

    pool = ThreadPoolExecutor(max_workers=2)
    auction_build = pool.submit(timed_build, auction_kernel.build)
    # the packed caches' host reader (g++), used from phase 15
    reader_build = pool.submit(timed_build, native_packed.load_library)
    pool.shutdown(wait=False)
    stem.build()
    print(f"build: {time.perf_counter() - t_build:.1f} s", flush=True)

    # 2-3. kernels against their plain versions (K3 in bf16 and f32)
    k3, k3f, k4 = phase_k3(stem, gen), phase_k3_f32(stem, gen), phase_k4(stem, gen)

    # 4. f32 engine, card vs CPU, small input
    cfg = default_model_config()
    rng = np.random.default_rng(SEED)
    small = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    sp2 = np.array([5.0, 20.0], np.float32)
    outs = [InferenceEngine(cfg, camera_hw=(96, 128), model_hw=(64, 64),
                            dtype=torch.float32, device=d).infer_batch(small, sp2)
            for d in ("cuda", "cpu")]
    for k in outs[1]:
        np.testing.assert_allclose(outs[0][k], outs[1][k], rtol=1e-3, atol=1e-4, err_msg=k)
    print("f32 engine: cuda matches cpu", flush=True)

    # 5. bf16 engine at full width
    frames = rng.integers(0, 256, (B_MAIN, 600, 800, 3), dtype=np.uint8)
    speeds = rng.uniform(0, 40, B_MAIN).astype(np.float32)
    calib = rng.integers(0, 256, (2, 600, 800, 3), dtype=np.uint8)
    bf16 = InferenceEngine(cfg, device="cuda")
    ref = bf16.infer_batch(frames, speeds)
    check_outputs(ref, B_MAIN, cfg)
    steps = {"bf16": step_ms(bf16, frames, speeds)}
    print(f"bf16 engine: ok, step {steps['bf16']:.3f} ms at B={B_MAIN}", flush=True)
    del bf16

    # 6. int8 engines: K3 (default stem), then K4 ("pool" stem)
    launches = {}
    for variant, kernel in (("fused", "s2d_stem_pool_int8"), ("pool", "maxpool3x3s2_int8")):
        eng = InferenceEngine(cfg, device="cuda", quantize=True, calib_frames=calib,
                              stem_variant=variant)
        stem.reset_launch_counts()
        out = eng.infer_batch(frames, speeds)
        counts = dict(stem.LAUNCHES)
        assert counts[kernel] == 1, (variant, counts)
        check_outputs(out, B_MAIN, cfg)
        wp_err = rel_err(ref["waypoints"], out["waypoints"])
        ew_err = float(np.abs(ref["expert_weights"] - out["expert_weights"]).max())
        assert wp_err < 0.03 and ew_err < 0.05, (variant, wp_err, ew_err)
        steps[f"int8-{variant}"] = step_ms(eng, frames, speeds)
        if variant == "pool":
            launches[kernel] = counts[kernel]
        print(f"int8 engine ({variant}): launches {counts}, waypoint rel err {wp_err:.2e}, "
              f"expert weight err {ew_err:.2e}, step {steps[f'int8-{variant}']:.3f} ms "
              f"at B={B_MAIN}", flush=True)
        del eng

    # 7. serving through the CLI entry point, 4 concurrent requests
    n_batches, launches["s2d_stem_pool_int8"] = serve_four(["--quantize"], frames, speeds)
    print(f"serving: 4 answers in {n_batches} batches", flush=True)

    # 8. the auction kernel's build (started in phase 1)
    print(f"build auction.cu: {auction_build.result():.1f} s", flush=True)

    # 9. K1+K2 against the plain version in three regimes
    k12 = phase_auction(auction_kernel, auction_regimes(gen))

    # 10. detection train steps, card against CPU
    train_step = phase_train_step()

    # 11. the training entry point at a user's default precision; its K1
    # launches are the main path's
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    with tempfile.TemporaryDirectory() as tmp:
        train_cli = phase_train_cli(Path(tmp))
    launches["auction_solve"] = train_cli["finetune-carla"]["launches"]

    # 12. detection → resume → gating → policy → int8 serving; its detection
    # checkpoint feeds phase 15's gating run
    tmp12 = tempfile.TemporaryDirectory()
    pipeline = phase_pipeline(Path(tmp12.name), frames, speeds)

    # 13. the other experts: K1+K2 at the nuScenes shapes; two nuScenes steps, card
    # against CPU (TF32 off); then, at the default precision, the nuScenes,
    # nuScenes-2D, segmentation and drivable trainers and int8 serving of a
    # LiDAR config
    k12_nus = phase_auction(auction_kernel, nuscenes_regimes(gen))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    nus_step = steps_card_vs_cpu(
        nuscenes_workload(num_queries=16, use_lidar=True, use_tnet=True, fusion="concat",
                          matcher="auction_kernel"), nuscenes_step_batches(), "nuscenes step")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    # its nuScenes and drivable checkpoints and caches feed phase 16
    tmp13 = tempfile.TemporaryDirectory()
    other = phase_other_experts(Path(tmp13.name), frames, speeds)

    # 14. the step options: card against CPU (TF32 off), then through the
    # entry points at the default precision
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    options_step = phase_step_options_card_vs_cpu()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    with tempfile.TemporaryDirectory() as tmp:
        options = phase_step_options(Path(tmp), frames, speeds)

    # 15. the fast data paths: the native reader, packed caches through the
    # trainers, the cached device-resident gating trainer, its checkpoint served
    reader_build_s = reader_build.result()
    print(f"build packed_reader.cpp: {reader_build_s:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fast = {"build_seconds": reader_build_s, "a": phase_packed_reader(Path(tmp))}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    fast["d"] = phase_cached_step_equals_experts_eval()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    with tempfile.TemporaryDirectory() as tmp:
        fast.update(phase_fast_data(
            Path(tmp), Path(tmp12.name) / "ckpt" / "bdd_detection" / "det" / "best.pt",
            pipeline["gating"], frames, speeds))

    # 16. the eval CLI on the card against the CPU (TF32 off), on phase 12's
    # and 13's checkpoints; then serving at f32 with int8 trunks
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ck12 = Path(tmp12.name) / "ckpt"
    with tempfile.TemporaryDirectory() as tmp:
        evals = phase_eval_cli(Path(tmp), ck12 / "bdd_detection" / "det" / "best.pt",
                               ck12 / "gating" / "gating" / "best.pt",
                               Path(tmp12.name) / "runs" / "bdd_detection_det",
                               Path(tmp13.name), frames, speeds)
    tmp13.cleanup()

    # 17. the closed loop through automoe-infer-torch (K3 at B=1 every control
    # step with --quantize), on phase 12's gating checkpoint too; then card
    # against CPU at f32 and with full context and top-k routing
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        loop = phase_closed_loop(Path(tmp), ck12 / "gating" / "gating" / "best.pt", frames,
                                 speeds)
    tmp12.cleanup()

    # 18. export bundles against the live engines, the server on a bundle, cold
    # start; then FusedAutoMoE against AutoMoE
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        bundles = phase_bundles(Path(tmp), frames, speeds, calib, smi)
    bundles["fused"] = phase_fused(smi)
    bundles["custom_op_host_us_b8"] = custom_op_host_us(stem, gen)

    # 19. the deep policy: an AdamW step card vs CPU (TF32 off), then the
    # trainer at full width (default precision)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    deep = {"a": phase_deep_policy_step()}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        deep["b-c"] = phase_deep_policy_cli(Path(tmp), smi)

    # 20. the staged program end to end, with the launcher, the supervisor
    # and the checks
    with tempfile.TemporaryDirectory() as tmp:
        campaign = phase_campaign(Path(tmp), smi)
    camp = campaign["a-b campaign"]

    # K1+K2 at a data-parallel rank's batch: 21b's ranks match B=16 each
    k12_b16 = phase_auction(auction_kernel, [
        (f"{name} B=16", b[:16].contiguous(), v[:16].contiguous(), e[:16].contiguous(), it)
        for name, b, v, e, it in auction_regimes(gen)])

    # 21. the whole-block parallel modes through the entry points, TF32 off:
    # a group of one, data parallel on 2 ranks, the pipeline, expert parallel
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        parallel = phase_parallel(Path(tmp), frames, speeds, smi)
        # 22. tensor parallel, spatial partitioning, the multi-rank cache and
        # resident epoch, data-parallel serving (on 21's caches)
        print(smi, flush=True)
        split = phase_split(Path(tmp), frames, speeds, smi)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults

    src = "automoe_tpu_torch/csrc/stem.cu"
    main_, big = k3[B_MAIN], k3[128]
    kernels = [{
        "name": "s2d_stem_pool_int8", "route": "cuda", "source": src,
        "replaces": "automoe_tpu/ops/pallas_stem.py:103",
        "launches": launches["s2d_stem_pool_int8"], "max_abs_err": main_["max_abs_err"],
        "diff_frac": main_["diff_frac"], "ms": main_["ms"], "plain_ms": main_["plain_ms"],
        "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
        # no single PyTorch call computes conv + bias + ReLU + quantize + pool
        "library_ms": None,
        "unfused_ms": main_["unfused_ms"],
        "unfused_is": "not a library call: cuDNN conv, bias + ReLU, quantize, K4 "
                      "(the \"pool\" stem variant's path)",
        "shape_batch": B_MAIN, "ms_blocks": main_["ms_blocks"],
        "wrapper_ms": main_["wrapper_ms"],
        "mixed_sign_inv_max_abs_err": main_["mixed_sign_inv_max_abs_err"],
        "mixed_sign_inv_diff_frac": main_["mixed_sign_inv_diff_frac"],
        # each main path, counted from 0 around it
        "launches_by_path": {"serve (phase 7)": launches["s2d_stem_pool_int8"],
                             "serve the gating checkpoint (phase 12)":
                                 pipeline["serve_gating_int8"]["k3_launches"],
                             "serve a LiDAR nuScenes config (phase 13)":
                                 other["serve_lidar_int8"]["k3_launches"],
                             "serve the gating checkpoint's EMA, --ema --quantize (phase 14e)":
                                 options["e"]["k3_launches"],
                             "serve the cached, device-resident gating checkpoint (phase 15e)":
                                 fast["e"]["k3_launches"],
                             "automoe-infer-torch --quantize, 200 steps at B=1 (phase 17)":
                                 loop["b --quantize"]["launches"]["s2d_stem_pool_int8"],
                             "the int8 bundle, a batch of 8 and one of 1 (phase 18a)":
                                 bundles["int8"]["launches"],
                             "automoe-serve-torch --bundle <int8 bundle> (phase 18b)":
                                 bundles["serve --bundle"]["k3_launches"],
                             "serve the expert-parallel gating checkpoint (phase 21d)":
                                 parallel["d"]["serve"]["k3_launches"],
                             "automoe-serve-torch --data-parallel --quantize, 1 replica "
                             "(phase 22d)": split["d"]["k3_launches"]},
        "b128": {k: big[k] for k in ("ms", "ms_blocks", "wrapper_ms", "plain_ms", "unfused_ms",
                                     "bound_ms", "max_abs_err", "diff_frac",
                                     "mixed_sign_inv_max_abs_err",
                                     "mixed_sign_inv_diff_frac")},
    }]
    one = k3[1]
    kernels.append({
        "name": "s2d_stem_pool_int8 (B=1, the closed loop)", "route": "cuda", "source": src,
        "replaces": "automoe_tpu/ops/pallas_stem.py:103",
        "launches": loop["b --quantize"]["launches"]["s2d_stem_pool_int8"],
        "max_abs_err": one["max_abs_err"], "diff_frac": one["diff_frac"], "ms": one["ms"],
        "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        # no single PyTorch call computes conv + bias + ReLU + quantize + pool
        "library_ms": None,
        "unfused_ms": one["unfused_ms"], "shape_batch": 1, "ms_blocks": one["ms_blocks"],
        "wrapper_ms": one["wrapper_ms"],
        "mixed_sign_inv_max_abs_err": one["mixed_sign_inv_max_abs_err"],
        "mixed_sign_inv_diff_frac": one["mixed_sign_inv_diff_frac"],
        "launches_by_path": {
            "automoe-infer-torch --quantize, 200 steps (phase 17b)":
                loop["b --quantize"]["launches"]["s2d_stem_pool_int8"],
            "automoe-infer-torch --checkpoint <gating best> --quantize, 50 steps (phase 17c)":
                loop["c --checkpoint <gating best> --quantize"]["launches"][
                    "s2d_stem_pool_int8"],
            "automoe-infer-torch --backend carla --quantize, 10 steps (phase 17d)":
                loop["d --backend carla"]["launches"]["s2d_stem_pool_int8"],
            "the staged program's export stage, its int8 frame (phase 20)":
                camp["k3_launches_export"]},
        "b2": {k: k3[2][k] for k in ("ms", "ms_blocks", "wrapper_ms", "plain_ms", "unfused_ms",
                                     "bound_ms", "bound_by", "max_abs_err", "diff_frac",
                                     "mixed_sign_inv_max_abs_err",
                                     "mixed_sign_inv_diff_frac")},
    })
    main_, small = k3f[32], k3f[B_MAIN]
    kernels.append({
        "name": "s2d_stem_pool_int8_f32", "route": "cuda", "source": src,
        "replaces": "automoe_tpu/ops/pallas_stem.py:103 (its f32 instantiation, :231, :254)",
        "launches": evals["gating --quantize"]["launches"]["s2d_stem_pool_int8_f32"],
        "max_abs_err": main_["max_abs_err"], "diff_frac": main_["diff_frac"],
        "ms": main_["ms"], "plain_ms": main_["plain_ms"], "bound_ms": main_["bound_ms"],
        "bound_by": main_["bound_by"],
        "bound_basis": "3 TF32 passes x 2*B*128*128*192*256 operations over 495 TFLOP/s "
                       "(dense TF32, H100 SXM data sheet), or the bytes over 3.35 TB/s",
        "design": "wgmma.m64n64k8 TF32, A from registers: each f32 value split as "
                  "hi = rna(v), lo = rna(v - hi); hi*hi + hi*lo + lo*hi in f32",
        # no single PyTorch call computes conv + bias + ReLU + quantize + pool
        "library_ms": None,
        "shape_batch": 32, "ms_blocks": main_["ms_blocks"], "wrapper_ms": main_["wrapper_ms"],
        "mixed_sign_inv_max_abs_err": main_["mixed_sign_inv_max_abs_err"],
        "mixed_sign_inv_diff_frac": main_["mixed_sign_inv_diff_frac"],
        "launches_by_path": {
            "automoe-eval-torch gating --quantize, 2 batches of 32 (phase 16)":
                evals["gating --quantize"]["launches"]["s2d_stem_pool_int8_f32"],
            "automoe-serve-torch --quantize --fp32 (phase 16)":
                evals["serve --quantize --fp32"]["k3_f32_launches"],
            "the int8 --fp32 bundle, a batch of 8 and one of 1 (phase 18a)":
                bundles["int8 --fp32"]["launches"]},
        "b8": {k: small[k] for k in ("ms", "ms_blocks", "wrapper_ms", "plain_ms", "bound_ms",
                                     "bound_by", "max_abs_err", "diff_frac",
                                     "mixed_sign_inv_max_abs_err",
                                     "mixed_sign_inv_diff_frac")},
    })
    main_, big = k4[B_MAIN], k4[128]
    kernels.append({
        "name": "maxpool3x3s2_int8", "route": "cuda", "source": src,
        "replaces": "automoe_tpu/ops/pallas_stem.py:149",
        "launches": launches["maxpool3x3s2_int8"], "max_abs_err": main_["max_abs_err"],
        "diff_frac": main_["diff_frac"], "ms": main_["ms"],
        "plain_ms": main_["plain_ms"], "bound_ms": main_["bound_ms"],
        "bound_by": main_["bound_by"],
        # CUDA max_pool2d has no int8 kernel
        "library_ms": None,
        "shape_batch": B_MAIN, "ms_blocks": main_["ms_blocks"],
        "wrapper_ms": main_["wrapper_ms"],
        "launches_by_path": {"int8 engine, pool stem (phase 6)": launches["maxpool3x3s2_int8"],
                             "the int8 pool-stem bundle, a batch of 8 and one of 1 (phase 18a)":
                                 bundles["int8 pool stem"]["launches"]},
        "b128": {k: big[k] for k in ("ms", "ms_blocks", "wrapper_ms", "plain_ms", "bound_ms",
                                     "max_abs_err", "diff_frac")},
    })
    div = k12["diverse"]
    kernels.append({
        "name": "auction_solve", "route": "cuda",
        "source": "automoe_tpu_torch/csrc/auction.cu",
        "replaces": "automoe_tpu/ops/pallas_auction.py:157 (+:39 _jv_exact)",
        "launches": launches["auction_solve"], "max_abs_err": div["max_abs_err"],
        "ms": div["ms"], "plain_ms": div["plain_ms"], "bound_ms": div["bound_ms"],
        "bound_by": div["bound_by"],
        # no PyTorch call solves an assignment
        "library_ms": None,
        "shape": [32, 48, 64], "escalated": div["escalated"], "rounds_max": div["rounds_max"],
        "ms_blocks": div["ms_blocks"], "wrapper_ms": div["wrapper_ms"],
        "launches_by_path": {
            "finetune-carla, 2 epochs (phase 11)": launches["auction_solve"],
            "finetune-carla resumed for epoch 2 (phase 12)":
                pipeline["detection_resume"]["launches_resumed_epoch2"],
            "nuscenes --use-lidar --use-tnet, 2 epochs (phase 13)":
                other["nuscenes"]["kernel_launches"],
            "nuscenes-2d, 1 epoch, max_iters=0 (phase 13)":
                other["nuscenes-2d"]["kernel_launches"],
            "bdd --bf16 --augment --qat --remat --ema-decay --grad-accum 2 (phase 14b)":
                options["b"]["kernel_launches"],
            "finetune-carla --steps-per-call 4 (phase 14c)":
                options["c"]["kernel_launches"],
            "bdd --packed-root, 2 epochs (phase 15b)":
                fast["b"]["packed-root"]["k1_launches"],
            "bdd --data-root, the same 2 epochs (phase 15b)":
                fast["b"]["data-root"]["k1_launches"],
            **{f"the staged program's {k} steps, K1 (phase 20)": v
               for k, v in camp["k1_launches"].items()},
            "the staged program's nuscenes-2d steps, K2 alone (phase 20)":
                camp["k2_alone_launches_nuscenes_2d"],
            **{f"bdd, {k} (phase 21a)": v["k1_launches"]
               for k, v in parallel["a"].items() if "k1_launches" in v},
            "bdd on 2 ranks of one card, rank 0 at B=16 (phase 21b)":
                parallel["b"]["k1_launches_per_rank"][0],
            "bdd --tp-min-dim 256 --model-axis 2, rank 0 of 2 at B=32 (phase 22a)":
                split["a"]["k1_launches_per_rank"][0],
            "bdd --tp-min-dim 256 --model-axis 2, rank 1 of 2 at B=32 (phase 22a)":
                split["a"]["k1_launches_per_rank"][1],
            "bdd --spatial --model-axis 2, rank 0 of 2 at B=32 (phase 22b)":
                split["b"]["k1_launches_per_rank"][0],
            "bdd --spatial --model-axis 2, rank 1 of 2 at B=32 (phase 22b)":
                split["b"]["k1_launches_per_rank"][1],
            "bdd --no-mesh, the reference of 22a-b (phase 22)":
                split["--no-mesh"]["k1_launches"],
            **{f"automoe-eval-torch {name}, max_iters=0 (phase 16)": v["launches"].get(
                "auction_solve", 0) for name, v in evals.items()
               if name in ("bdd detection", "bdd detection --quantize", "nuscenes",
                           "visualize-detection")}},
        **{name: {k: v[name][k] for k in ("shape", "ms", "ms_blocks", "wrapper_ms", "plain_ms",
                                          "bound_ms", "bound_by", "max_abs_err",
                                          "scipy_cost_gap", "scipy_cost_gap_rel",
                                          "escalated", "rounds_max",
                                          "jv_scans_max", "max_iters")}
           for v, names in ((k12, ("degenerate", "jv")), (k12_nus, list(k12_nus)),
                            (k12_b16, list(k12_b16)))
           for name in names},
    })
    print(json.dumps({"engine_step_ms_b8": steps}), flush=True)
    print(json.dumps({"train_step_cuda_vs_cpu": train_step, "train_cli": train_cli}),
          flush=True)
    print(json.dumps({"pipeline": pipeline}), flush=True)
    print(json.dumps({"other_experts": {"nuscenes_step_cuda_vs_cpu": nus_step, **other}}),
          flush=True)
    print(json.dumps({"step_options": {"card_vs_cpu": options_step, **options}}), flush=True)
    print(json.dumps({"fast_data": fast}), flush=True)
    print(json.dumps({"eval_cli": evals}), flush=True)
    print(json.dumps({"closed_loop": loop}), flush=True)
    print(json.dumps({"bundles": bundles}), flush=True)
    print(json.dumps({"deep_policy": deep}), flush=True)
    print(json.dumps({"campaign": campaign}), flush=True)
    print(json.dumps({"parallel": parallel}), flush=True)
    print(json.dumps({"split": split}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_cards() -> int:
    """`--cards`: only phase 21's and 22's comparisons with one rank a card."""
    import torch

    from automoe_tpu_torch.ops import auction_kernel, stem

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    auction_kernel.build()
    stem.build()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    frames = np.random.default_rng(SEED).integers(0, 256, (4, 600, 800, 3), dtype=np.uint8)
    speeds = np.array([0.0, 10.0, 20.0, 30.0], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        cards = phase_parallel_cards(Path(tmp), smi)
        print(smi, flush=True)
        cards["split"] = phase_split_cards(Path(tmp), smi, frames, speeds)
    print(json.dumps({"parallel_cards": cards}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
