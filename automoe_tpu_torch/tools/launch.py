"""Pipeline orchestrator (port of automoe_tpu/tools/launch.py), the
counterpart of the reference bash launchers (training/train_bdd100k_experts
_ddp.sh, finetune_experts_carla.sh, train_gating_network.sh: sequential
jobs, SKIP_* flags, env-tunable epochs/batch sizes, fail-fast). One Python
process drives the whole multi-stage pipeline through the port's trainer
(`automoe_tpu_torch.train.cli.main`), stage after stage.

Env tunables (parity with the launchers' heads): EPOCHS, BATCH_SIZE,
DATA_ROOT, RUN_NAME, IMAGE_SIZE, SKIP_DETECTION, SKIP_SEGMENTATION,
SKIP_DRIVABLE, SKIP_NUSCENES, SKIP_POLICY, SKIP_GATING.

`--device` (default cuda) is forwarded to every stage; without a GPU and
without `--device cpu` the launcher raises before the first stage.
`--no-mesh` and the mesh flags (`--model-axis`, `--spatial`,
`--tp-min-dim`, `--multihost`, `--coordinator`, `--num-processes`,
`--process-id`) are forwarded to
every stage, which applies the trainer's meaning and refusals. The summary (each stage's
status and seconds) is printed and written to
<log-dir>/<pipeline>_<run-name>.json; JAX's launcher only makes the
directory.

    automoe-launch-torch bdd-experts|finetune-carla|policy-gating [--epochs N]
        [--batch-size B] [--data-root DIR] [--device cpu] [--keep-going] ...
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


def _stage_args(stage: List[str], args) -> List[str]:
    out = list(stage)
    out += ["--epochs", str(args.epochs), "--batch-size", str(args.batch_size)]
    if args.data_root:
        out += ["--data-root", args.data_root]
    out += ["--run-name", args.run_name, "--ckpt-root", args.ckpt_root,
            "--runs-root", args.runs_root]
    out += ["--device", args.device]
    if args.no_mesh:
        out += ["--no-mesh"]
    if args.model_axis != 1:
        out += ["--model-axis", str(args.model_axis)]
    if args.multihost:
        out += ["--multihost"]
    if args.spatial:
        out += ["--spatial"]
    if args.tp_min_dim:
        out += ["--tp-min-dim", str(args.tp_min_dim)]
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            out += ["--" + flag.replace("_", "-"), str(getattr(args, flag))]
    if args.image_size:
        out += ["--image-size", str(args.image_size)]
    if args.num_workers is not None:
        out += ["--num-workers", str(args.num_workers)]
    # stage-specific knobs (only the subcommands that accept them)
    if stage[0] == "policy" and args.horizon:
        out += ["--horizon", str(args.horizon)]
    if stage[0] == "gating" and args.model_config:
        out += ["--model-config", args.model_config]
    return out


PIPELINES: Dict[str, List[List[str]]] = {
    # train_bdd100k_experts_ddp.sh: 3 sequential expert jobs
    "bdd-experts": [
        ["bdd", "--task", "detection"],
        ["bdd", "--task", "drivable"],
        ["bdd", "--task", "segmentation"],
    ],
    # finetune_experts_carla.sh: 4 fine-tune jobs
    "finetune-carla": [
        ["finetune-carla", "--task", "detection"],
        ["finetune-carla", "--task", "segmentation"],
        ["finetune-carla", "--task", "drivable"],
        ["nuscenes-2d"],
    ],
    # train_gating_network.sh: policy then gating
    "policy-gating": [
        ["policy"],
        ["gating"],
    ],
}

_SKIP_KEYS = {
    "detection": "SKIP_DETECTION",
    "segmentation": "SKIP_SEGMENTATION",
    "drivable": "SKIP_DRIVABLE",
    "nuscenes-2d": "SKIP_NUSCENES",
    "policy": "SKIP_POLICY",
    "gating": "SKIP_GATING",
}


def _stage_name(stage: List[str]) -> str:
    if "--task" in stage:
        return stage[stage.index("--task") + 1]
    return stage[0]


def main(argv=None):
    from automoe_tpu_torch.train.cli import main as train_main
    from automoe_tpu_torch.utils import resolve_device

    p = argparse.ArgumentParser("automoe-launch-torch")
    p.add_argument("pipeline", choices=sorted(PIPELINES))
    p.add_argument("--epochs", type=int,
                   default=int(os.environ.get("EPOCHS", 1)))
    p.add_argument("--batch-size", type=int,
                   default=int(os.environ.get("BATCH_SIZE", 32)))
    p.add_argument("--data-root", default=os.environ.get("DATA_ROOT"))
    p.add_argument("--run-name", default=os.environ.get("RUN_NAME", "pipeline"))
    p.add_argument("--ckpt-root", default="checkpoints")
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--log-dir", default="logs",
                   help="where the summary goes: <log-dir>/<pipeline>_<run-name>.json")
    p.add_argument("--no-mesh", action="store_true",
                   help="forwarded: each stage runs one process with no group")
    p.add_argument("--model-axis", type=int, default=1, help="forwarded to every stage")
    p.add_argument("--multihost", action="store_true",
                   help="forwarded, with --coordinator, --num-processes and --process-id: "
                        "this launcher is one rank of each stage's world")
    p.add_argument("--spatial", action="store_true", help="forwarded to every stage")
    p.add_argument("--tp-min-dim", type=int, default=0, help="forwarded to every stage")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage (default cuda; 'cpu' runs without a "
                        "GPU)")
    p.add_argument("--image-size", type=int,
                   default=int(os.environ.get("IMAGE_SIZE", 0)) or None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--horizon", type=int, default=None,
                   help="forwarded to policy stages")
    p.add_argument("--model-config", default=None,
                   help="forwarded to gating stages")
    p.add_argument("--keep-going", action="store_true",
                   help="continue past failed stages (default: fail fast)")
    args = p.parse_args(argv)
    resolve_device(args.device)

    summary = []
    for stage in PIPELINES[args.pipeline]:
        name = _stage_name(stage)
        if _env_flag(_SKIP_KEYS.get(name, f"SKIP_{name.upper()}")):
            print(f"[launch] SKIP {name}")
            summary.append((name, "skipped", 0.0))
            continue
        t0 = time.time()
        print(f"[launch] >>> {name}: {' '.join(stage)}")
        try:
            train_main(_stage_args(stage, args))
            summary.append((name, "ok", time.time() - t0))
        except (Exception, SystemExit):
            # SystemExit too: argparse errors / cmd_* sys.exit in a stage
            # must hit --keep-going and the summary, not kill the launcher
            traceback.print_exc()
            summary.append((name, "FAILED", time.time() - t0))
            if not args.keep_going:
                break
    print("[launch] summary:")
    for name, status, dt in summary:
        print(f"  {name:14s} {status:8s} {dt:7.1f}s")
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    (log_dir / f"{args.pipeline}_{args.run_name}.json").write_text(json.dumps(
        [{"stage": name, "status": status, "seconds": dt} for name, status, dt in summary],
        indent=1))
    if any(s == "FAILED" for _, s, _ in summary):
        sys.exit(1)


if __name__ == "__main__":
    main()
