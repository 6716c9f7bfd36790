"""Where a detection train step's memory goes, with the ResNet-18 trunk
whole and split by height over M ranks (`--spatial`, parallel/sp.py).

    python -m automoe_tpu_torch.tools.sp_memory [--model-axis 2]
        [--size 256] [--batch 32] [--box-cap 48] [--seed 0] [--device cuda] [--tf32]

Runs one forward and backward of `bdd_expert_workload("detection")`'s loss
on one seeded synthetic batch (profile_train's scenes), first in this
process with the trunk whole, then on `--model-axis` ranks (subprocesses
joined over gloo on localhost, all on this card, data 1 x model M) with
the trunk split. TF32 is off unless `--tf32`. For each process it prints one JSON line:

  * `saved_mib`: the bytes autograd holds for the backward after the
    forward (each storage counted once, the parameters left out), in all
    and by the autograd node that holds them (`saved_mib_by_node`; a
    storage two nodes share is counted under the first one met walking
    the graph back from the loss);
  * on a card, from the caching allocator, above what was allocated
    before the forward (the model and the batch): `forward_peak_mib`,
    `retained_mib` (after the forward: what the backward starts from) and
    `backward_peak_mib`; and `base_mib`, that starting point;
  * on a card, `train_step_peak_mib`: the whole peak of two train steps
    as the training CLI takes them (AdamW, its moments included), the
    figure `chip_smoke.py` phase 22 reads off a whole CLI run; and
    `step3`, a third step with the allocator's history recorded: the peak
    of what it allocated (above what the step started with), what was
    live at that peak by the line of this package that allocated it, its
    largest blocks, and the allocation that reached it.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from typing import Dict, Optional, Sequence

import numpy as np

MIB = 2 ** 20


def saved_by_node(root, params) -> Dict[str, float]:
    """MiB autograd saved for the backward, by node type, walking the graph
    back from `root` (each storage once; parameters left out)."""
    import torch

    skip = {p.untyped_storage().data_ptr() for p in params}
    seen_nodes, seen = set(), set()
    by: Dict[str, float] = collections.Counter()
    stack = [root]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen_nodes:
            continue
        seen_nodes.add(fn)
        tensors = []
        for name in dir(fn):
            if name.startswith("_saved_"):
                try:
                    v = getattr(fn, name)
                except RuntimeError:  # freed or not a tensor
                    continue
                vs = v if isinstance(v, (tuple, list)) else [v]
                tensors += [t for t in vs if torch.is_tensor(t)]
        if hasattr(fn, "saved_tensors"):  # a custom autograd Function
            tensors += [t for t in fn.saved_tensors if t is not None]
        for t in tensors:
            ptr = t.untyped_storage().data_ptr()
            if ptr in skip or ptr in seen:
                continue
            seen.add(ptr)
            by[type(fn).__name__] += t.untyped_storage().nbytes() / MIB
        stack += [f for f, _ in fn.next_functions]
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def live_at_peak(snapshot, top: int = 12) -> Dict:
    """Replays the allocator's recorded trace: the peak of the bytes
    allocated while recording, and the blocks live at that moment grouped
    by the innermost frame of this package that allocated them (MiB)."""
    events = [e for t in snapshot["device_traces"] for e in t]
    live, cur, peak, at_peak, last = {}, 0, 0, {}, None
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            cur += e["size"]
            if cur > peak:
                peak, at_peak, last = cur, dict(live), e
        elif e["action"] in ("free_requested", "free_completed") and e["addr"] in live:
            cur -= live.pop(e["addr"])["size"]

    def where(e) -> str:
        ours = [f for f in e.get("frames", []) if "automoe_tpu_torch" in f["filename"]]
        # the frame nearest the allocation: the trace lists the calls from
        # the innermost or from the outermost, and this tool is outermost
        if ours and ours[0]["filename"].endswith("sp_memory.py"):
            ours = ours[::-1]
        return (f"{ours[0]['filename'].rsplit('automoe_tpu_torch/', 1)[-1]}:"
                f"{ours[0]['line']} {ours[0]['name']}" if ours else "elsewhere")

    by: Dict[str, float] = collections.Counter()
    for e in at_peak.values():
        by[where(e)] += e["size"] / MIB
    big = sorted(at_peak.values(), key=lambda e: -e["size"])[:top]
    return {"peak_mib": peak / MIB,
            "live_at_peak_mib": dict(sorted(by.items(), key=lambda kv: -kv[1])[:top]),
            "largest_live_at_peak": [[e["size"] / MIB, where(e)] for e in big],
            "peak_reached_by": None if last is None else [last["size"] / MIB, where(last)]}


def measure(args, mesh=None) -> Dict:
    import torch

    from automoe_tpu_torch.data.collate import pad_boxes
    from automoe_tpu_torch.tools.synth import scene
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(args.seed)
    images, boxes, labels = [], [], []
    for _ in range(args.batch):
        img, b, lab = scene(rng, args.size, int(rng.integers(1, 21)), 10)
        pb, pl = pad_boxes(b, lab, args.box_cap)
        images.append(img.transpose(1, 2, 0))
        boxes.append(pb)
        labels.append(pl)
    batch = {k: torch.from_numpy(np.stack(v)).to(dev)
             for k, v in (("image", images), ("bboxes", boxes), ("labels", labels))}
    wl = bdd_expert_workload("detection", bbox_loss_weight=1.0)
    model = wl.init_model(args.seed, dev).train()
    if mesh is not None:
        from automoe_tpu_torch.parallel.batchnorm import convert_batchnorm
        from automoe_tpu_torch.parallel.sp import spatial_model

        convert_batchnorm(model, mesh)
        spatial_model(model, mesh)
    out = {"mode": "split" if mesh is not None else "whole",
           "rank": 0 if mesh is None else mesh.rank, "size": args.size, "batch": args.batch,
           "tf32": args.tf32}
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    loss, _ = wl.loss_fn(model, batch, True)
    by = saved_by_node(loss.grad_fn, list(model.parameters()))
    out["saved_mib"] = sum(by.values())
    out["saved_mib_by_node"] = by
    if not cuda:  # a CPU run counts the saved bytes only
        return out
    torch.cuda.synchronize()
    out["base_mib"] = base / MIB
    out["forward_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / MIB
    out["retained_mib"] = (torch.cuda.memory_allocated() - base) / MIB
    torch.cuda.reset_peak_memory_stats()
    loss.backward()
    torch.cuda.synchronize()
    out["backward_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / MIB
    del loss
    model.zero_grad(set_to_none=True)
    # the CLI's step: AdamW at the detection trainer's defaults, two steps
    opt = make_optimizer(model.named_parameters(), learning_rate=2e-4, weight_decay=1e-5,
                         total_steps=10)
    if mesh is not None:
        opt.shard(mesh, {})
    step = make_train_step(wl.loss_fn)
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        float(step(model, opt, batch, (args.seed, i))["loss"])
    out["train_step_peak_mib"] = torch.cuda.max_memory_allocated() / MIB
    # a third step with the allocator's history recorded
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=200000, stacks="python")
    float(step(model, opt, batch, (args.seed, 2))["loss"])
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    out["step3"] = live_at_peak(snap)
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-axis", type=int, default=2)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--box-cap", type=int, default=48)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tf32", action="store_true",
                   help="convolutions in TF32 (PyTorch's default, which the training CLI "
                        "keeps; chip_smoke.py's phase 22 turns it off)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = args.tf32
    if args.rank is not None:  # one rank of the split run
        from automoe_tpu_torch.parallel.mesh import MeshSpec, clear_mesh, init_world, make_mesh

        init_world(args.coordinator, args.model_axis, args.rank, args.device)
        mesh = make_mesh(MeshSpec(data=1, model=args.model_axis), device=args.device)
        print(json.dumps(measure(args, mesh)), flush=True)
        clear_mesh()
        return
    if args.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
        print(json.dumps({"card": smi}), flush=True)
    print(json.dumps(measure(args)), flush=True)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    cmd = [sys.executable, "-m", "automoe_tpu_torch.tools.sp_memory", "--coordinator", coord,
           "--model-axis", str(args.model_axis), "--size", str(args.size), "--batch",
           str(args.batch), "--box-cap", str(args.box_cap), "--seed", str(args.seed),
           "--device", args.device, *(["--tf32"] if args.tf32 else [])]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env={**os.environ})
             for r in range(args.model_axis)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for proc in procs:
            proc.kill()
    if any(rcs):
        raise SystemExit(f"a rank failed: exit codes {rcs}")


if __name__ == "__main__":
    main()
