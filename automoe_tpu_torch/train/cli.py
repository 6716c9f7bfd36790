"""Training CLI of the port, `automoe-train-torch` (port of
automoe_tpu/train/cli.py):

  bdd --task detection             ← automoe-train bdd --task detection
  finetune-carla --task detection  ← automoe-train finetune-carla --task detection
  policy                           ← automoe-train policy (--epochs 0: shape dry-run)
  gating                           ← automoe-train gating (expert ckpt graft + freeze)

Flags and per-subcommand defaults are the JAX CLI's, checkpoint and resume
flags included (`--ckpt-root`, `--save-freq`, `--resume`, `--resume-from`,
`--save-every-steps`, `--keep-epochs`, `--async-ckpt`, `--init-from`).
Every other flag of that CLI, every other task and subcommand, exits with
"not ported yet"; none is silently ignored. `--device` (default cuda;
raises without a GPU unless it is `cpu`) is the port's own.
"""
from __future__ import annotations

import argparse
import json
import sys

from automoe_tpu_torch.train import workloads as W
from automoe_tpu_torch.train.loop import TrainConfig, Trainer

#: the JAX CLI's subcommands and flags this port does not have yet
_NOT_PORTED_COMMANDS = ("nuscenes", "nuscenes-2d", "preset")
_NOT_PORTED_FLAGS = (
    "--packed-root", "--bf16", "--no-mesh", "--model-axis", "--spatial", "--tp-min-dim",
    "--remat", "--augment", "--qat", "--multihost", "--coordinator", "--num-processes",
    "--process-id", "--debug-nans", "--max-inflight", "--profile-dir", "--steps-per-call",
    "--grad-accum", "--ema-decay",
)
_NOT_PORTED_POLICY_FLAGS = ("--trunk-depth", "--trunk-width", "--pp-microbatches")
_NOT_PORTED_GATING_FLAGS = ("--parallelism", "--cache-expert-features", "--device-resident",
                            "--feature-cache-dir")

#: the reference trainers' schedule cadences (train/state.py::make_optimizer)
_DEFAULT_SCHEDULE = {"policy": "constant", "gating": "cosine_per_epoch"}


class _NotPorted(argparse.Action):
    def __init__(self, option_strings, dest, **kw):
        super().__init__(option_strings, dest, nargs="?", default=argparse.SUPPRESS,
                         help=argparse.SUPPRESS)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet")


def _reject(p: argparse.ArgumentParser, flags) -> None:
    for flag in flags:
        p.add_argument(flag, action=_NotPorted)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-root", default=None)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--run-name", default="run")
    p.add_argument("--ckpt-root", default="checkpoints")
    p.add_argument("--runs-root", default="runs")
    p.add_argument("--save-freq", type=int, default=0,
                   help="N>0 also writes epoch_N every N epochs")
    p.add_argument("--resume", choices=["model", "full"], default=None)
    p.add_argument("--resume-from", default="last",
                   help="best | last | epoch_N | step (mid-epoch checkpoint written by "
                        "--save-every-steps; falls back to last)")
    p.add_argument("--save-every-steps", type=int, default=0,
                   help="N>0 writes a mid-epoch 'step' checkpoint every N optimizer steps "
                        "(resume with --resume full --resume-from step)")
    p.add_argument("--async-ckpt", action="store_true",
                   help="write checkpoints from a background thread (the weights "
                        "snapshot stays synchronous)")
    p.add_argument("--keep-epochs", type=int, default=0,
                   help="with --save-freq: keep only the newest K epoch_N checkpoints "
                        "(best/last/step are never removed); 0 keeps all")
    p.add_argument("--init-from", default=None,
                   help="seed the model's weights and BatchNorm statistics from another "
                        "run's checkpoint file of the same model before training; the "
                        "optimizer starts fresh, and nothing is seeded when --resume "
                        "restored a checkpoint")
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
                   help="LR schedule cadence (default: the reference trainer's: cosine per "
                        "optimizer step for experts, constant for policy, cosine_per_epoch "
                        "for gating)")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    _reject(p, _NOT_PORTED_FLAGS)


def _train_cfg(args, pipeline: str = "") -> TrainConfig:
    return TrainConfig(
        schedule=args.schedule or _DEFAULT_SCHEDULE.get(pipeline, "cosine"),
        epochs=args.epochs, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, seed=args.seed, run_name=args.run_name,
        ckpt_root=args.ckpt_root, runs_root=args.runs_root, save_freq=args.save_freq,
        keep_epochs=args.keep_epochs, async_ckpt=args.async_ckpt, resume=args.resume,
        resume_from=args.resume_from, save_every_steps=args.save_every_steps,
        device=args.device)


def _args_dump(args) -> dict:
    return {k: v for k, v in vars(args).items()
            if isinstance(v, (str, int, float, bool, type(None), list))}


def _loaders(factory, args, **kw):
    # --seed sets the shuffle too (the JAX CLI leaves its loaders at seed 0)
    common = dict(batch_size=args.batch_size, num_workers=args.num_workers, seed=args.seed)
    if args.data_root:
        common["root_dir"] = args.data_root
    train = factory(split="train", **common, **kw)
    val = factory(split="val", shuffle=False, **common, **kw)
    return train, val


def _sized_loaders(factory, args, **kw):
    """_loaders, after checking --image-size against the cache's images."""
    train, val = _loaders(factory, args, **kw)
    hw = train.dataset[0]["image"].shape[:2]
    if hw != (args.image_size, args.image_size):
        raise SystemExit(f"--image-size {args.image_size}: the cache under "
                         f"{args.data_root} holds {hw[0]}x{hw[1]} images")
    return train, val


def _graft_init_from(trainer: Trainer, args) -> Trainer:
    """--init-from seeds fresh state only: when --resume restored a
    checkpoint of this run, grafting the source again would roll trained
    weights back on every relaunch."""
    if args.init_from and not trainer.resumed:
        from automoe_tpu_torch.ckpt import load_variables

        load_variables(args.init_from, trainer.model)
        print(f"[cli] warm-started weights and BatchNorm statistics from {args.init_from}",
              flush=True)
    return trainer


def _run_detection(args, factory):
    if args.task != "detection":
        raise SystemExit(f"--task {args.task} is not ported yet")
    wl = W.bdd_expert_workload(args.task, bbox_loss_weight=args.bbox_loss_weight,
                               matcher=args.matcher)
    train, val = _sized_loaders(factory, args, box_cap=args.box_cap)
    return _graft_init_from(Trainer(wl, train, val, _train_cfg(args)), args).fit(_args_dump(args))


def cmd_bdd(args):
    from automoe_tpu_torch.data import get_bdd_detection_loader

    return _run_detection(args, get_bdd_detection_loader)


def cmd_finetune_carla(args):
    from automoe_tpu_torch.data import get_carla_detection_loader

    return _run_detection(args, get_carla_detection_loader)


def cmd_policy(args):
    import torch

    from automoe_tpu_torch.data import get_carla_sequence_loader
    from automoe_tpu_torch.utils import resolve_device

    wl = W.policy_workload(horizon=args.horizon, context_dim=args.context_dim)
    if args.epochs == 0:
        # dry-run shape check (the reference's train_carla_policy.py:178-188)
        dev = resolve_device(args.device)
        model = wl.init_model(args.seed, dev).eval()
        image = torch.zeros(2, 3, args.image_size, args.image_size, device=dev)
        ctx = torch.zeros(2, args.context_dim, device=dev) if args.context_dim else None
        with torch.no_grad():
            out = model(image, ctx)
        print({k: tuple(v.shape) for k, v in out.items()}, flush=True)
        return {"dry_run": True}
    train, val = _sized_loaders(get_carla_sequence_loader, args, horizon=args.horizon)
    trainer = Trainer(wl, train, val, _train_cfg(args, "policy"))
    return _graft_init_from(trainer, args).fit(_args_dump(args))


def cmd_gating(args):
    from automoe_tpu_torch.ckpt import load_expert_checkpoints
    from automoe_tpu_torch.configs import default_model_config, load_model_config
    from automoe_tpu_torch.data import get_carla_sequence_loader

    cfg = load_model_config(args.model_config) if args.model_config else default_model_config()
    wl = W.gating_workload(cfg, loss_config=json.loads(args.loss_config or "{}"),
                           freeze_experts=not args.unfreeze_experts)
    train, val = _sized_loaders(get_carla_sequence_loader, args,
                                horizon=cfg.policy.num_waypoints)
    trainer = _graft_init_from(Trainer(wl, train, val, _train_cfg(args, "gating")), args)
    # expert checkpoints seed fresh state only: after a real restore,
    # grafting them again would roll the experts' BatchNorm statistics
    # (or, with --unfreeze-experts, their trained weights) back on every
    # relaunch; a relaunch that found nothing to restore still grafts
    if args.expert_ckpts and not trainer.resumed:
        load_expert_checkpoints(trainer.model, cfg, args.expert_ckpts.split(","))
    return trainer.fit(_args_dump(args))


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

    pp = sub.add_parser("policy")
    pp.add_argument("--horizon", type=int, default=8)
    pp.add_argument("--context-dim", type=int, default=0)
    _reject(pp, _NOT_PORTED_POLICY_FLAGS)
    _add_common(pp)
    # the reference policy CLI defaults to epochs=0 (a dry-run shape check)
    pp.set_defaults(fn=cmd_policy, epochs=0, batch_size=32, learning_rate=3e-4,
                    weight_decay=1e-4)

    pg = sub.add_parser("gating")
    pg.add_argument("--model-config", default=None, help="JSON file or string")
    pg.add_argument("--expert-ckpts", default=None,
                    help="comma-separated checkpoint files, one per expert ('' skips one)")
    pg.add_argument("--loss-config", default=None, help="JSON string")
    pg.add_argument("--unfreeze-experts", action="store_true")
    _reject(pg, _NOT_PORTED_GATING_FLAGS)
    _add_common(pg)
    pg.set_defaults(fn=cmd_gating, epochs=100, batch_size=8, learning_rate=1e-4,
                    weight_decay=1e-4)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
