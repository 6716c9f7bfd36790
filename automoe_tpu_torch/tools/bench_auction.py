"""K1 + K2 alone on the GPU: one or more builds of csrc/auction.cu, timed side by side.

    python -m automoe_tpu_torch.tools.bench_auction [--against OTHER/auction.cu ...]

Compiles the package's csrc/auction.cu and every `--against` source (each
exports automoe_auction_solve; a source whose entry point has no
`escalate` parameter is called without it) with the package's nvcc flags
plus `-Xptxas -v`, all at once, and prints ptxas's registers, spill bytes
and static shared memory of each build's auction kernel. Then, for each
regime of `auction_regimes` (B=32, N=48, Q=64: diverse, degenerate,
JV only), it prints the plain version's loop counts (auction rounds, max
and mean over the elements; the escalated elements and their JV scans),
holds every build against the plain version (identical assignments), and
times its entry point launched back to back on the same pre-masked
inputs: five blocks of 50 launches, the builds interleaved block by block
(the order reversed every other round), the median block per build.
Prints JSON lines, the card's name and power limit first.
`nuscenes_regimes` gives the nuScenes trainers' shapes (Q=100, and Q=196
with K2 alone) to `chip_smoke.py` and the `cuda` tests.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from automoe_tpu_torch.tools.bench_stem import (build_verbose, card_name, interleaved_ms,
                                                  ptxas_usage)

SEED = 0
_SIGNATURE = re.compile(r"int\s+automoe_auction_solve\s*\(([^)]*)\)")


def auction_regimes(gen):
    """B=32, N=48, Q=64 (256x256 images, box cap 48) in three regimes:
    (name, benefit, valid, eps, max_iters), on the card."""
    import torch

    from automoe_tpu_torch.ops.matching import match_cost_matrix

    B, N, Q, C = 32, 48, 64, 10
    # diverse: random costs (tests/test_pallas_auction.py recipe)
    benefit = -torch.rand(B, N, Q, device="cuda", generator=gen) * 10
    valid = torch.ones(B, N, dtype=torch.bool, device="cuda")
    valid[1, 5:] = False
    valid[2] = False
    # degenerate: the clustered predictions of an untrained detector
    logits = (torch.randn(1, 1, C, device="cuda", generator=gen)
              + 1e-3 * torch.randn(B, Q, C, device="cuda", generator=gen))
    boxes = (torch.tensor([0.4, 0.4, 0.6, 0.6], device="cuda")
             + 1e-3 * torch.randn(B, Q, 4, device="cuda", generator=gen)).clamp(0, 1)
    tb = torch.rand(B, N, 4, device="cuda", generator=gen) * 0.8 + 0.1
    tl = torch.randint(0, C, (B, N), device="cuda", generator=gen)
    deg = -match_cost_matrix(logits, boxes, tb, tl).transpose(1, 2).contiguous()
    # max_iters=0: every element through JV, with invalid rows and elements
    jv_valid = valid.clone()
    jv_valid[3, ::2] = False
    jv_valid[4, 40:] = False

    all_valid = torch.ones_like(valid)
    return [("diverse", benefit, valid, _eps_of(benefit, valid), 128),
            ("degenerate", deg, all_valid, _eps_of(deg, all_valid), 128),
            ("jv", benefit, jv_valid, _eps_of(benefit, jv_valid), 0)]


def _eps_of(b, v):
    """The matcher's eps (ops/auction_kernel.py::auction_match_kernel)."""
    import torch

    b = torch.where(v[..., None], b, torch.zeros_like(b))
    return (b.amax((1, 2)) - b.amin((1, 2))).clamp(min=1e-3) * 1e-6 / v.shape[1]


def nuscenes_regimes(gen):
    """The shapes the nuScenes trainers give K1 + K2, on the card:
    (name, benefit, valid, eps, max_iters). `nuscenes` training matches
    B=32 samples, N=48 targets (the CLI's box cap) and Q=100 queries on
    7-dim boxes (BEV GIoU in the cost), targets of positive sizes: diverse
    predictions, clustered ones, an untrained head's raw outputs, and
    negative sizes on both sides (costs ~1e10), each element with 1..48
    real targets, cap 128. `nuscenes-2d` matches exactly: B=16, N=48,
    Q=196 on cxcywh boxes, max_iters=0 (K2 alone). On the generator's
    device."""
    import torch

    from automoe_tpu_torch.ops.matching import match_cost_matrix

    dev = gen.device

    def sized(boxes):
        """Positive sizes: cxcywh boxes, or [cx,cy,cz,w,l,h,yaw] with w, l, h
        > 0, as real targets have them."""
        if boxes.shape[-1] == 4:
            return boxes.abs() + 0.5
        return torch.cat([boxes[..., :3], boxes[..., 3:6].abs() + 0.5, boxes[..., 6:]], -1)

    def targets(B, N, D, C=10):
        tb = sized(torch.randn(B, N, D, device=dev, generator=gen) * 3)
        n = torch.randint(1, N + 1, (B, 1), device=dev, generator=gen)
        tl = torch.randint(0, C, (B, N), device=dev, generator=gen)
        tl = torch.where(torch.arange(N, device=dev) < n, tl, -1)
        return tb, tl

    out = []
    B, N, Q, C = 32, 48, 100, 10
    tb, tl = targets(B, N, 7)
    for name, spread in (("nuscenes-diverse", 1.0), ("nuscenes-degenerate", 1e-3)):
        logits = (torch.randn(1, 1, C, device=dev, generator=gen)
                  + spread * torch.randn(B, Q, C, device=dev, generator=gen))
        boxes = sized(torch.randn(1, 1, 7, device=dev, generator=gen)
                      + 3 * spread * torch.randn(B, Q, 7, device=dev, generator=gen))
        benefit = -match_cost_matrix(logits, boxes, tb, tl).transpose(1, 2).contiguous()
        out.append((name, benefit, tl >= 0, _eps_of(benefit, tl >= 0), 128))
    B, Q = 16, 196
    tb, tl = targets(B, N, 4)
    logits = torch.randn(B, Q, C, device=dev, generator=gen)
    boxes = sized(torch.randn(B, Q, 4, device=dev, generator=gen) * 3)
    benefit = -match_cost_matrix(logits, boxes, tb, tl).transpose(1, 2).contiguous()
    out.append(("nuscenes-2d-jv", benefit, tl >= 0, _eps_of(benefit, tl >= 0), 0))
    B, Q = 32, 100
    tb, tl = targets(B, N, 7)
    # an untrained head's raw outputs (small, about half the sizes negative)
    # against real targets
    logits = 0.1 * torch.randn(B, Q, C, device=dev, generator=gen)
    boxes = 0.5 * torch.randn(B, Q, 7, device=dev, generator=gen)
    benefit = -match_cost_matrix(logits, boxes, tb, tl).transpose(1, 2).contiguous()
    out.append(("nuscenes-untrained", benefit, tl >= 0, _eps_of(benefit, tl >= 0), 128))
    # negative sizes on both sides (tools/synth.py::nuscenes_batch's boxes,
    # which profile_train and the step checks feed): where both footprints
    # are inverted the hull clamps to 1e-9 and the costs reach ~1e10
    tb_neg = torch.randn(B, N, 7, device=dev, generator=gen) * 3
    boxes = (torch.randn(1, 1, 7, device=dev, generator=gen)
             + 3 * torch.randn(B, Q, 7, device=dev, generator=gen))
    benefit = -match_cost_matrix(logits, boxes, tb_neg, tl).transpose(1, 2).contiguous()
    out.append(("nuscenes-negative-sizes", benefit, tl >= 0, _eps_of(benefit, tl >= 0), 128))
    return out


def scipy_gap_limit(optimum: float) -> float:
    """How far an element's assignment may miss scipy's float64 optimum in
    total cost: 1e-4 while the optimum's magnitude stays under 1e6, else
    1e-7 of it (the kernel and its plain version add float32 costs, whose
    rounding grows with their size: ~1e3 at costs ~1e10)."""
    return 1e-4 if abs(optimum) < 1e6 else 1e-7 * abs(optimum)


def has_escalate(src: Path) -> bool:
    """Whether the source's automoe_auction_solve takes an escalate flag."""
    m = _SIGNATURE.search(src.read_text())
    if not m:
        raise ValueError(f"{src} defines no automoe_auction_solve")
    return "escalate" in m[1]


def _build(src: Path, out_dir: Path):
    lib, log = build_verbose(src, out_dir, ["--fmad=false"])
    # the kernel of the main path: for Q = 64 the instantiation with two
    # columns per lane where the kernel is a template, else the only one
    try:
        usage = ptxas_usage(log, "auction_kernelILi2E")
    except ValueError:
        usage = ptxas_usage(log, "auction_kernel")
    p, i = ctypes.c_void_p, ctypes.c_int
    esc = has_escalate(src)
    lib.automoe_auction_solve.argtypes = [p, p, p, p, i, i, i, i] + ([i] if esc else []) + [p]
    lib.automoe_auction_solve.restype = i
    return lib, usage, esc


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", action="append", default=[], type=Path,
                   help="another auction.cu to time beside the package's")
    args = p.parse_args(argv)

    import torch

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.ops._ext import BUILD_DIR

    print(json.dumps({"card": card_name()}), flush=True)
    sources = [Path(ak.__file__).resolve().parents[1] / "csrc" / "auction.cu", *args.against]
    out_dir = BUILD_DIR.parent / "bench_auction"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = list(pool.map(lambda s: _build(s, out_dir), sources))
    for src, (_, usage, esc) in zip(sources, built):
        print(json.dumps({"source": str(src), "ptxas": usage, "escalate_arg": esc}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for name, benefit, valid, eps, max_iters in auction_regimes(gen):
        B, N, Q = benefit.shape
        b = torch.where(valid[..., None], benefit, torch.zeros_like(benefit)).contiguous()
        v = valid.to(torch.int32).contiguous()
        e = eps.float().contiguous()
        ref = ak.auction_solve_plain(b, valid, e, max_iters=max_iters)
        counts = {k: t.cpu().numpy() for k, t in
                  ak.auction_counts_plain(b, valid, e, max_iters).items()}
        esc_rows = counts["escalated"]
        print(json.dumps({
            "regime": name, "max_iters": max_iters,
            "rounds_max": int(counts["rounds"].max()),
            "rounds_mean": float(counts["rounds"].mean()),
            "escalated": int(esc_rows.sum()),
            "jv_scans_total": int(counts["jv_scans"].sum()),
            "jv_scans_mean_escalated": (float(counts["jv_scans"][esc_rows].mean())
                                        if esc_rows.any() else 0.0),
            "jv_scans_max": int(counts["jv_scans"].max())}), flush=True)
        outs = [torch.empty(B, N, dtype=torch.int32, device="cuda") for _ in built]

        def launch(k: int) -> None:
            lib, _, esc = built[k]
            extra = (1,) if esc else ()
            ak.raise_on(lib.automoe_auction_solve(
                b.data_ptr(), v.data_ptr(), e.data_ptr(), outs[k].data_ptr(), B, N, Q,
                max_iters, *extra, stream), "auction_solve")

        same = []
        for k in range(len(built)):
            launch(k)
            torch.cuda.synchronize()
            same.append(bool(torch.equal(outs[k], ref)))
            for _ in range(3):
                launch(k)
        blocks = interleaved_ms(launch, len(built))
        for k, src in enumerate(sources):
            print(json.dumps({"regime": name, "source": str(src),
                              "ms": float(np.median(blocks[k])), "ms_blocks": blocks[k],
                              "equal_to_plain": same[k]}), flush=True)


if __name__ == "__main__":
    main()
