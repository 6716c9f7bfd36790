"""Training CLI of the port, `automoe-train-torch` (port of
automoe_tpu/train/cli.py for the detection expert):

  bdd --task detection             ← automoe-train bdd --task detection
  finetune-carla --task detection  ← automoe-train finetune-carla --task detection

Flags and per-subcommand defaults are the JAX CLI's. Every other flag of
that CLI, every other task and subcommand, exits with "not ported yet";
none is silently ignored. `--device` (default cuda; raises without a GPU
unless it is `cpu`) is the port's own.
"""
from __future__ import annotations

import argparse
import sys

from automoe_tpu_torch.train import workloads as W
from automoe_tpu_torch.train.loop import TrainConfig, Trainer

#: the JAX CLI's subcommands and flags this port does not have yet
_NOT_PORTED_COMMANDS = ("nuscenes", "nuscenes-2d", "policy", "gating", "preset")
_NOT_PORTED_FLAGS = (
    "--packed-root", "--ckpt-root", "--save-freq", "--resume", "--resume-from",
    "--save-every-steps", "--async-ckpt", "--keep-epochs", "--init-from", "--bf16",
    "--no-mesh", "--model-axis", "--spatial", "--tp-min-dim", "--remat", "--augment",
    "--qat", "--multihost", "--coordinator", "--num-processes", "--process-id",
    "--debug-nans", "--max-inflight", "--profile-dir", "--steps-per-call", "--grad-accum",
    "--ema-decay",
)


class _NotPorted(argparse.Action):
    def __init__(self, option_strings, dest, **kw):
        super().__init__(option_strings, dest, nargs="?", default=argparse.SUPPRESS,
                         help=argparse.SUPPRESS)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-root", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--run-name", default="run")
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--box-cap", type=int, default=48)
    p.add_argument("--matcher", default=None,
                   help="set-matching solver: auction | auction_kernel | hungarian; the "
                        "auction matchers take an iteration-cap suffix ('auction_kernel:256'); "
                        "auction_pallas is accepted as auction_kernel (default: auction_kernel "
                        "on CUDA, auction elsewhere)")
    p.add_argument("--schedule", default=None,
                   choices=["cosine", "constant", "cosine_per_epoch"],
                   help="LR schedule cadence (default: cosine per optimizer step)")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    for flag in _NOT_PORTED_FLAGS:
        p.add_argument(flag, action=_NotPorted)


def _train_cfg(args) -> TrainConfig:
    return TrainConfig(schedule=args.schedule or "cosine", epochs=args.epochs,
                       learning_rate=args.learning_rate, weight_decay=args.weight_decay,
                       seed=args.seed, run_name=args.run_name, runs_root=args.runs_root,
                       device=args.device)


def _loaders(factory, args, **kw):
    # --seed sets the shuffle too (the JAX CLI leaves its loaders at seed 0)
    common = dict(batch_size=args.batch_size, num_workers=args.num_workers, seed=args.seed)
    if args.data_root:
        common["root_dir"] = args.data_root
    train = factory(split="train", **common, **kw)
    val = factory(split="val", shuffle=False, **common, **kw)
    return train, val


def _run_detection(args, factory):
    if args.task != "detection":
        raise SystemExit(f"--task {args.task} is not ported yet")
    wl = W.bdd_expert_workload(args.task, bbox_loss_weight=args.bbox_loss_weight,
                               matcher=args.matcher)
    train, val = _loaders(factory, args, box_cap=args.box_cap)
    hw = train.dataset[0]["image"].shape[:2]
    if hw != (args.image_size, args.image_size):
        raise SystemExit(f"--image-size {args.image_size}: the cache under "
                         f"{args.data_root} holds {hw[0]}x{hw[1]} images")
    return Trainer(wl, train, val, _train_cfg(args)).fit()


def cmd_bdd(args):
    from automoe_tpu_torch.data import get_bdd_detection_loader

    return _run_detection(args, get_bdd_detection_loader)


def cmd_finetune_carla(args):
    from automoe_tpu_torch.data import get_carla_detection_loader

    return _run_detection(args, get_carla_detection_loader)


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] in _NOT_PORTED_COMMANDS:
        raise SystemExit(f"automoe-train-torch: {argv[0]} is not ported yet")
    p = argparse.ArgumentParser("automoe-train-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    tasks = ["detection", "segmentation", "drivable"]

    pb = sub.add_parser("bdd")
    pb.add_argument("--task", choices=tasks, required=True)
    pb.add_argument("--bbox-loss-weight", type=float, default=2.0)
    _add_common(pb)
    pb.set_defaults(fn=cmd_bdd, epochs=50, batch_size=32, learning_rate=1e-4,
                    weight_decay=1e-5)

    pf = sub.add_parser("finetune-carla")
    pf.add_argument("--task", choices=tasks, required=True)
    # the CARLA fine-tune weighs the bbox loss 1.0, the BDD trainer 2.0
    pf.add_argument("--bbox-loss-weight", type=float, default=1.0)
    _add_common(pf)
    pf.set_defaults(fn=cmd_finetune_carla, epochs=20, batch_size=16, learning_rate=2e-4,
                    weight_decay=1e-5)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
