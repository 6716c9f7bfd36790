#!/usr/bin/env python3
"""Smoke run of the PyTorch port (automoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (none is caught):
  1. build the CUDA kernels from automoe_tpu_torch/csrc, one nvcc per
     source, all started together (stem.cu timed here, auction.cu in 8);
  2. K3, the fused int8 stem kernel, against its plain PyTorch version
     at B=8 and B=128, 256x256 input: int8 outputs within ±1 on at most
     0.1% of elements, with inv > 0 and with inv of both signs; the
     kernel's time alone (back-to-back launches of the library's entry
     point, three blocks of 50) and through its
     wrapper, beside the plain version and the unfused "pool"-variant
     path (serving/quant.py::s2d_stem_pool_unfused: cuDNN conv, quantize,
     K4) at the same shapes;
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
     total cost within 1e-4 of scipy's linear_sum_assignment, and with
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
     detection` on a BDD-format cache where PIL imports;
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
     TCP requests with K3 launched once per server batch.

Prints the card's name and power limit, one JSON line of kernel results,
and, last, {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device or outside a checkout of the repository.
"""
from __future__ import annotations

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


def stem_kernel_ms(stem, xs, w, bias, inv, blocks: int = 3, iters: int = 50) -> list:
    """K3 alone: the library's entry point launched back to back on pre-built
    inputs (no wrapper checks, no launch count), CUDA events around each
    block of `iters` launches; the mean of each block."""
    import torch

    lib = stem.build()
    B, hp, wp, _ = xs.shape
    O = w.shape[1]
    out = torch.empty((B, *stem.pool_out_hw(hp - 4, wp - 4), O), dtype=torch.int8,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        stem.raise_on(lib.automoe_stem_s2d_pool_int8(
            xs.data_ptr(), w.data_ptr(), bias.data_ptr(), inv.data_ptr(), out.data_ptr(),
            B, hp, wp, O, stream), "s2d_stem_pool_int8")

    return [cuda_ms(launch, iters=iters) for _ in range(blocks)]


def phase_k3(stem, gen):
    """K3 against its plain version at B=8 and B=128: int8 outputs within
    ±1 on at most 0.1% of elements, with inv > 0 and with inv of both
    signs. Times: the kernel alone (three blocks of 50 back-to-back
    launches, the median block), its wrapper (median of 30 calls, one event
    pair each), the plain version (mean of 5) and the unfused
    "pool"-variant path (three blocks of 20, the median block)."""
    import torch

    from automoe_tpu_torch.serving.quant import s2d_stem_pool_unfused

    res = {}
    for B in (B_MAIN, 128):
        args = stem_inputs(B, gen)
        out = stem.s2d_stem_pool_int8(*args)
        torch.cuda.synchronize()
        ref = stem.s2d_stem_pool_int8_plain(*args)
        d = (out.int() - ref.int()).abs()
        max_err, frac = int(d.max()), float((d > 0).float().mean())
        assert out.shape == (B, 64, 64, 256) and out.dtype == torch.int8
        assert max_err <= 1 and frac <= 1e-3, (B, max_err, frac)
        # inv of both signs (about half the channels negative, one zero)
        xs, w, bias, inv = args
        sign = torch.where(torch.rand(256, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
        mixed = (xs, w, bias, inv * sign * (torch.arange(256, device="cuda") != 7))
        d = (stem.s2d_stem_pool_int8(*mixed).int()
             - stem.s2d_stem_pool_int8_plain(*mixed).int()).abs()
        torch.cuda.synchronize()
        mixed_err, mixed_frac = int(d.max()), float((d > 0).float().mean())
        assert mixed_err <= 1 and mixed_frac <= 1e-3, (B, mixed_err, mixed_frac)
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


def phase_auction(ak, gen):
    import torch

    from automoe_tpu_torch.tools.bench_auction import auction_regimes

    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:
        linear_sum_assignment = None
    res = {}
    for name, benefit, valid, eps, max_iters in auction_regimes(gen):
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
        gap = 0.0
        if linear_sum_assignment is not None:
            cost = (-benefit).double().cpu().numpy()
            o, v = out.cpu().numpy(), valid.cpu().numpy()
            for b in range(cost.shape[0]):
                rows = np.where(v[b])[0]
                if not len(rows):
                    assert (o[b] == -1).all()
                    continue
                sub = cost[b][rows]
                ri, ci = linear_sum_assignment(sub)
                gap = max(gap, abs(sub[np.arange(len(rows)), o[b][rows]].sum()
                                   - sub[ri, ci].sum()))
            assert gap <= 1e-4, (name, gap)
        valid_i = valid.int()
        b_ms, b_by = bound(0.0, PEAK_BF16_FLOPS, nbytes(benefit, valid_i, eps, out))
        blocks = kernel_ms(ak, benefit, valid, eps, max_iters)
        res[name] = dict(
            max_abs_err=int((out - ref).abs().max()), escalated=escalated,
            rounds_max=int(counts["rounds"].max()), jv_scans_max=int(counts["jv_scans"].max()),
            max_iters=max_iters, scipy_cost_gap=gap if linear_sum_assignment else None,
            ms=float(np.median(blocks)), ms_blocks=blocks,
            wrapper_ms=cuda_ms_median(lambda: ak.auction_solve(benefit, valid, eps,
                                                               max_iters=max_iters), iters=30),
            plain_ms=cuda_ms_median(lambda: ak.auction_solve_plain(
                masked, valid, eps, max_iters=max_iters), iters=3, warmup=1),
            bound_ms=b_ms, bound_by=b_by)
        print(f"K1+K2 {name}: {res[name]}", flush=True)
    return res


def phase_train_step():
    """Two SGD steps on the card (K1) and on the CPU (plain version)."""
    import torch

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
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
    wl = bdd_expert_workload("detection", matcher="auction_kernel")
    step = make_train_step(wl.loss_fn)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(SEED, torch.device(dev))
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, weight_decay=0.0,
                             total_steps=2, optimizer="sgd")
        n0 = ak.LAUNCHES["auction_solve"]
        losses = [float(step(model, opt, {k: torch.from_numpy(v).to(dev)
                                          for k, v in b.items()})["loss"]) for b in batches]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     ak.LAUNCHES["auction_solve"] - n0)
    assert runs["cuda"][2] == 2 and runs["cpu"][2] == 0, "K1 not launched once per card step"
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    worst = 0.0
    for k, v in runs["cpu"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
            worst = max(worst, float((runs["cuda"][1][k] - v).abs().max()))
    print(f"train step: cuda losses {runs['cuda'][0]} cpu losses {runs['cpu'][0]}, "
          f"max param diff {worst:.3e}", flush=True)
    return {"losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
            "max_param_abs_diff": worst}


def phase_train_cli(tmp: Path):
    """automoe-train-torch on synthetic caches; returns per-subcommand results."""
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import synth_bdd_detection, synth_carla_detection
    from automoe_tpu_torch.train.cli import main as train_main

    runs = {"finetune-carla": (synth_carla_detection, 2)}
    try:
        import PIL  # noqa: F401

        runs["bdd"] = (synth_bdd_detection, 1)
    except ImportError:
        print("train CLI: PIL missing, bdd skipped", flush=True)
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


def serve_four(argv, frames, speeds):
    """automoe-serve-torch with `argv` answers 4 concurrent TCP requests;
    returns (server batches, K3 launches counted from 0 around them)."""
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
        launches = stem.LAUNCHES["s2d_stem_pool_int8"]
        n_batches = batcher.stats["batches"]
    finally:
        srv.shutdown()
        batcher.close()
    for a in answers:
        assert a is not None and a["waypoints"].shape == (10, 2)
        assert np.isfinite(a["waypoints"]).all()
        np.testing.assert_allclose(a["expert_weights"].sum(), 1.0, rtol=1e-2)
    assert launches == n_batches >= 1, (launches, n_batches)
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
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.ops import auction_kernel, stem

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

    def timed_auction_build():
        auction_kernel.build()
        return time.perf_counter() - t_build

    pool = ThreadPoolExecutor(max_workers=1)
    auction_build = pool.submit(timed_auction_build)
    pool.shutdown(wait=False)
    stem.build()
    print(f"build: {time.perf_counter() - t_build:.1f} s", flush=True)

    # 2-3. kernels against their plain versions
    k3, k4 = phase_k3(stem, gen), phase_k4(stem, gen)

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
    k12 = phase_auction(auction_kernel, gen)

    # 10. detection train steps, card against CPU
    train_step = phase_train_step()

    # 11. the training entry point at a user's default precision; its K1
    # launches are the main path's
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    with tempfile.TemporaryDirectory() as tmp:
        train_cli = phase_train_cli(Path(tmp))
    launches["auction_solve"] = train_cli["finetune-carla"]["launches"]

    # 12. detection → resume → gating → policy → int8 serving
    with tempfile.TemporaryDirectory() as tmp:
        pipeline = phase_pipeline(Path(tmp), frames, speeds)

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
                                 pipeline["serve_gating_int8"]["k3_launches"]},
        "b128": {k: big[k] for k in ("ms", "ms_blocks", "wrapper_ms", "plain_ms", "unfused_ms",
                                     "bound_ms", "max_abs_err", "diff_frac",
                                     "mixed_sign_inv_max_abs_err",
                                     "mixed_sign_inv_diff_frac")},
    }]
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
        "launches_by_path": {"int8 engine, pool stem (phase 6)": launches["maxpool3x3s2_int8"]},
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
                pipeline["detection_resume"]["launches_resumed_epoch2"]},
        **{name: {k: k12[name][k] for k in ("ms", "ms_blocks", "wrapper_ms", "plain_ms",
                                            "bound_ms", "max_abs_err", "escalated",
                                            "rounds_max", "jv_scans_max", "max_iters")}
           for name in ("degenerate", "jv")},
    })
    print(json.dumps({"engine_step_ms_b8": steps}), flush=True)
    print(json.dumps({"train_step_cuda_vs_cpu": train_step, "train_cli": train_cli}),
          flush=True)
    print(json.dumps({"pipeline": pipeline}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
