#!/usr/bin/env python3
"""Smoke run of the PyTorch port (automoe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (none is caught):
  1. build the CUDA kernels from automoe_tpu_torch/csrc (timed);
  2. K3, the fused int8 stem kernel, against its plain PyTorch version
     at B=8 and B=128, 256x256 input: int8 outputs within ±1 on at most
     0.1% of elements; times from CUDA events;
  3. K4, the int8 3x3/s2 pool kernel, against its plain version at
     [8,128,128,256] and [128,128,128,256]: bit-exact; times;
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

Prints the card's name and power limit, one JSON line of kernel results,
and, last, {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

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


def phase_k3(stem, gen):
    import torch

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
        flops = 2.0 * B * 128 * 128 * 192 * 256
        b_ms, b_by = bound(flops, PEAK_BF16_FLOPS, nbytes(*args, out))
        res[B] = dict(max_abs_err=max_err, diff_frac=frac,
                      ms=cuda_ms(lambda: stem.s2d_stem_pool_int8(*args)),
                      plain_ms=cuda_ms(lambda: stem.s2d_stem_pool_int8_plain(*args), 5),
                      bound_ms=b_ms, bound_by=b_by)
        print(f"K3 B={B}: {res[B]}", flush=True)
    return res


def phase_k4(stem, gen):
    """No single PyTorch call computes it on CUDA: max_pool2d has no int8
    kernel there, so the line's library_ms is null."""
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
        res[B] = dict(max_abs_err=int((out.int() - ref.int()).abs().max()), diff_frac=0.0,
                      ms=cuda_ms(lambda: stem.maxpool3x3s2_int8(x)),
                      plain_ms=cuda_ms(lambda: stem.maxpool3x3s2_int8_plain(x), 5),
                      bound_ms=b_ms, bound_by=b_by)
        print(f"K4 B={B}: {res[B]}", flush=True)
    return res


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
    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.serving import Client
    from automoe_tpu_torch.serving.cli import main as serve_main

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # 1. build
    t0 = time.perf_counter()
    stem.build()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)

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
    srv, batcher = serve_main(["--quantize", "--port", "0", "--max-batch", "4"],
                              block=False)
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
        launches["s2d_stem_pool_int8"] = stem.LAUNCHES["s2d_stem_pool_int8"]
        n_batches = batcher.stats["batches"]
    finally:
        srv.shutdown()
        batcher.close()
    for a in answers:
        assert a is not None and a["waypoints"].shape == (10, 2)
        assert np.isfinite(a["waypoints"]).all()
        np.testing.assert_allclose(a["expert_weights"].sum(), 1.0, rtol=1e-2)
    assert launches["s2d_stem_pool_int8"] == n_batches >= 1, (launches, n_batches)
    print(f"serving: 4 answers in {n_batches} batches", flush=True)

    src = "automoe_tpu_torch/csrc/stem.cu"
    kernels = []
    for name, res, replaces in (
        ("s2d_stem_pool_int8", k3, "automoe_tpu/ops/pallas_stem.py:103"),
        ("maxpool3x3s2_int8", k4, "automoe_tpu/ops/pallas_stem.py:149"),
    ):
        main_, big = res[B_MAIN], res[128]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": main_["max_abs_err"],
            "diff_frac": main_["diff_frac"], "ms": main_["ms"],
            "plain_ms": main_["plain_ms"], "bound_ms": main_["bound_ms"],
            "bound_by": main_["bound_by"],
            # no single PyTorch call computes either function (K3 is conv +
            # bias + ReLU + quantize + pool; CUDA max_pool2d has no int8)
            "library_ms": None,
            "shape_batch": B_MAIN,
            "b128": {k: big[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "max_abs_err", "diff_frac")},
        })
    print(json.dumps({"engine_step_ms_b8": steps}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
