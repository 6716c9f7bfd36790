"""Training CLI of the port, `automoe-train-torch` (port of
automoe_tpu/train/cli.py):

  bdd --task T             ← automoe-train bdd --task T (detection|segmentation|drivable)
  finetune-carla --task T  ← automoe-train finetune-carla --task T
  nuscenes                 ← automoe-train nuscenes (camera, + LiDAR with --use-lidar)
  nuscenes-2d              ← automoe-train nuscenes-2d (CARLA image-only 2D fine-tune)
  policy                   ← automoe-train policy (--epochs 0: shape dry-run)
  gating                   ← automoe-train gating (expert ckpt graft + freeze)

Flags and per-subcommand defaults are the JAX CLI's, checkpoint and resume
flags included (`--ckpt-root`, `--save-freq`, `--resume`, `--resume-from`,
`--save-every-steps`, `--keep-epochs`, `--async-ckpt`, `--init-from`), and
so are the step options (`--bf16`, `--ema-decay`, `--grad-accum`,
`--steps-per-call`, `--max-inflight`, `--remat`, `--qat`, `--augment`,
`--debug-nans`, `--profile-dir`), `--packed-root` on every subcommand
(a cache that `automoe-pack-torch` wrote, read by the native reader) and
gating's `--cache-expert-features`, `--feature-cache-dir` and
`--device-resident`, with the JAX CLI's guards. Where the JAX CLI gives an
option no effect (--remat and --qat for policy and gating, --augment where
the workload has none), the port says so. The mesh flags are the JAX
CLI's too: `--multihost --coordinator host:port --num-processes N
--process-id i` start this process as rank i of a world of N processes
(one process per card: parallel/mesh.py; gloo on the CPU and when ranks
share a card, NCCL when each has its own), `--model-axis M` splits the
world data x M, `--no-mesh` runs one process with no group; data-parallel
ranks read their own sampler shard of --batch-size rows each; policy's
`--pp-microbatches` pipelines the deep trunk over the model axis,
gating's `--parallelism ep` runs one expert a rank, `--tp-min-dim N`
splits every weight whose output dim is >= N over the model axis
(parallel/tp.py) and `--spatial` splits the ResNet trunks' maps by height
over it (parallel/sp.py), with the JAX CLI's refusals. On several ranks
gating's `--cache-expert-features` shares its pass over the data ranks
(rank 0 writes the file) and `--device-resident` stages each data rank's
shard. `preset <name-or-path> [overrides...]` expands one of
the JSON run configs in automoe_tpu_torch/configs/presets/ (the JAX
package's, byte for byte; `preset --list` names them) into its
subcommand's flags, the trailing overrides last. As in the JAX CLI,
segmentation and drivable take no box cap and run no matcher, and
nuscenes-2d always matches exactly (matcher 'hungarian'), so
`--box-cap` / `--matcher` have no effect there. `--device` (default
cuda; raises without a GPU unless it is `cpu`) is the port's own.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

from automoe_tpu_torch.train import workloads as W
from automoe_tpu_torch.train.loop import TrainConfig, Trainer

#: the reference trainers' schedule cadences (train/state.py::make_optimizer)
_DEFAULT_SCHEDULE = {"policy": "constant", "gating": "cosine_per_epoch"}


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-root", default=None)
    p.add_argument("--packed-root", default=None,
                   help="packed columnar cache root (automoe-pack-torch output; "
                        "<root>/{train,val}), read by the native C++ batch gather instead "
                        "of per-sample loads")
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
                   help="set-matching solver: auction | auction_kernel | hungarian (exact: "
                        "K2 alone on CUDA, scipy on the CPU); the auction matchers take an iteration-cap suffix ('auction_kernel:256'); "
                        "auction_pallas is accepted as auction_kernel (default: auction_kernel "
                        "on CUDA, auction elsewhere)")
    p.add_argument("--schedule", default=None,
                   choices=["cosine", "constant", "cosine_per_epoch"],
                   help="LR schedule cadence (default: the reference trainer's: cosine per "
                        "optimizer step for experts, constant for policy, cosine_per_epoch "
                        "for gating)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (params stay fp32): the forward under bf16 autocast")
    p.add_argument("--remat", action="store_true",
                   help="rematerialisation: checkpoint each backbone block — the backward "
                        "recomputes one block at a time instead of holding the whole "
                        "stack's activations (~1 extra forward of FLOPs for the stack's "
                        "activation memory); for batches/resolutions that don't fit "
                        "otherwise")
    p.add_argument("--augment", action="store_true",
                   help="on-device augmentation in the train step (random resized crop + "
                        "hflip + color jitter, box/mask-consistent label geometry, keyed "
                        "by (seed, step) — ops/augment.py); expert pipelines only; OFF by "
                        "default (the reference has none)")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware training: fake-quantize backbone conv weights "
                        "(per-channel int8) and inputs (per-tensor int8) with the "
                        "straight-through estimator, so the model trains against the grid "
                        "the int8 serving path deploys (ops/fake_quant.py; stem stays "
                        "float)")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.detect_anomaly over training, and raise at the "
                        "first non-finite train loss (reads every loss; slow; debugging "
                        "only)")
    p.add_argument("--max-inflight", type=int, default=2,
                   help="train steps allowed in flight before the host waits on the "
                        "oldest (0 = sync every step)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the first trained epoch into "
                        "this dir (Chrome trace JSON: Perfetto, chrome://tracing)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K>1 runs K optimizer steps per call (one stacked H2D + one "
                        "loss read-back per K steps; K batches of device memory for "
                        "inputs)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="K>1 accumulates gradients over K loader batches and applies "
                        "their average as ONE optimizer step (effective batch K x "
                        "batch-size with one microbatch of activations live — composes "
                        "with --remat for memory; BN normalizes per microbatch, torch "
                        "grad-accum semantics)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="d>0 tracks an EMA of params (updated after each optimizer "
                        "step), validates it per epoch (val_ema), uses it for the "
                        "best-checkpoint decision, and saves it in checkpoints for "
                        "automoe-serve-torch --ema. Typical: 0.999")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--no-mesh", action="store_true",
                   help="one process, no process group")
    p.add_argument("--model-axis", type=int, default=1,
                   help="mesh 'model'-axis size (the world's processes split data x model); "
                        "required > 1 by --spatial and --tp-min-dim")
    p.add_argument("--spatial", action="store_true",
                   help="spatial partitioning: split the ResNet trunks' image HEIGHT over "
                        "the 'model' axis with hand-written halo exchanges "
                        "(parallel/sp.py): each rank keeps about 1/M of the trunk's "
                        "activations, its peak falls less (tools/sp_memory.py measures "
                        "it); needs --model-axis > 1 dividing the image height")
    p.add_argument("--tp-min-dim", type=int, default=0,
                   help="tensor parallelism: split weights whose output dim is >= this "
                        "(and divisible by the 'model' axis) over 'model', column-parallel "
                        "(parallel/tp.py); 0 = off; needs --model-axis > 1; exclusive with "
                        "--spatial")
    p.add_argument("--multihost", action="store_true",
                   help="join a world of processes (with --coordinator, --num-processes, "
                        "--process-id) before anything else")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous, with --multihost")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _train_cfg(args, pipeline: str = "") -> TrainConfig:
    return TrainConfig(
        schedule=args.schedule or _DEFAULT_SCHEDULE.get(pipeline, "cosine"),
        epochs=args.epochs, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, seed=args.seed, run_name=args.run_name,
        ckpt_root=args.ckpt_root, runs_root=args.runs_root, save_freq=args.save_freq,
        keep_epochs=args.keep_epochs, async_ckpt=args.async_ckpt, resume=args.resume,
        resume_from=args.resume_from, save_every_steps=args.save_every_steps,
        max_inflight=args.max_inflight, steps_per_call=args.steps_per_call,
        profile_dir=args.profile_dir, grad_accum=args.grad_accum,
        ema_decay=args.ema_decay, debug_nans=args.debug_nans, device=args.device,
        pp_microbatches=getattr(args, "pp_microbatches", 0), spatial=args.spatial,
        tp_min_dim=args.tp_min_dim)


def _dtype(args):
    import torch

    return torch.bfloat16 if args.bf16 else torch.float32


def _no_effect(args, pipeline: str, why: Dict[str, str]) -> None:
    """Print the JAX CLI's note for each given option this pipeline ignores."""
    for flag, reason in why.items():
        if getattr(args, flag):
            print(f"[cli] --{flag}: no effect for {pipeline} ({reason})", flush=True)


def _args_dump(args) -> dict:
    return {k: v for k, v in vars(args).items()
            if isinstance(v, (str, int, float, bool, type(None), list))}


def _world_size(args) -> int:
    return args.num_processes if args.multihost else 1


def _world_guards(args) -> None:
    """Refusals that need only the flags: made before the group is joined
    (a refused rank must not leave the others waiting at the rendezvous)."""
    if args.multihost and None in (args.coordinator, args.num_processes, args.process_id):
        raise SystemExit("--multihost needs --coordinator host:port, --num-processes and "
                         "--process-id (the port reads no cluster from its environment)")
    if args.no_mesh and _world_size(args) > 1:
        raise SystemExit("--no-mesh runs one process with no process group; drop "
                         "--multihost")
    if args.cmd == "gating":
        _gating_guards(args)


def _mesh(args, *, data: int = -1, model: int = 0):
    """The run's mesh over the world (None with --no-mesh), checked with
    the JAX package's words (its refusals of --spatial and --tp-min-dim
    without a 'model' axis, made where the JAX CLI makes them: not for
    expert parallelism's own mesh)."""
    if args.no_mesh:
        if args.spatial:
            raise SystemExit("--spatial requires a device mesh")
        if args.tp_min_dim > 0:
            raise SystemExit("--tp-min-dim requires a device mesh")
        return None
    if not model:
        if args.spatial and args.model_axis < 2:
            raise SystemExit("--spatial needs --model-axis > 1")
        if args.tp_min_dim > 0 and args.model_axis < 2:
            raise SystemExit("--tp-min-dim needs --model-axis > 1")
        if args.spatial and args.tp_min_dim > 0:
            raise SystemExit("--spatial and --tp-min-dim are exclusive (both consume the "
                             "'model' mesh axis)")
    from automoe_tpu_torch.parallel import MeshSpec, make_mesh

    try:  # the Trainer resolves the device (and raises without a GPU)
        mesh = make_mesh(MeshSpec(data=data, model=model or args.model_axis),
                         device=args.device or "cuda")
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if mesh.size > 1 and mesh.is_main:
        print(f"[mesh] {mesh.shape['data']}x{mesh.shape['model']} over {mesh.size} "
              f"processes: backend {mesh.backend}, staging {mesh.staging_label}, "
              f"device {mesh.device}", flush=True)
    return mesh


def _loaders(factory, args, mesh=None, **kw):
    # --seed sets the shuffle too (the JAX CLI leaves its loaders at seed 0);
    # each data rank reads its own shard of --batch-size rows
    common = dict(batch_size=args.batch_size, num_workers=args.num_workers, seed=args.seed)
    if mesh is not None:
        common.update(num_shards=mesh.shape["data"], shard_index=mesh.data_index)
    if args.data_root:
        common["root_dir"] = args.data_root
    if getattr(args, "packed_root", None):
        common["packed_root"] = args.packed_root
    train = factory(split="train", **common, **kw)
    val = factory(split="val", shuffle=False, **common, **kw)
    return train, val


def _sized_loaders(factory, args, mesh=None, **kw):
    """_loaders, after checking --image-size against the cache's images."""
    train, val = _loaders(factory, args, mesh, **kw)
    hw = train.dataset[0]["image"].shape[:2]
    if hw != (args.image_size, args.image_size):
        raise SystemExit(f"--image-size {args.image_size}: the cache under "
                         f"{getattr(args, 'packed_root', None) or args.data_root} holds "
                         f"{hw[0]}x{hw[1]} images")
    return train, val


def _graft_init_from(trainer: Trainer, args) -> Trainer:
    """--init-from seeds fresh state only: when --resume restored a
    checkpoint of this run, grafting the source again would roll trained
    weights back on every relaunch."""
    if args.init_from and not trainer.resumed:
        trainer.load_variables(args.init_from)
        trainer.reset_ema()  # the average starts at the seeded weights
        print(f"[cli] warm-started weights and BatchNorm statistics from {args.init_from}",
              flush=True)
    return trainer


def _trainer(wl, train, val, cfg: TrainConfig, mesh):
    """The Trainer, under the mesh when it has more than one rank (a
    group of one runs the single-process path, as --no-mesh does)."""
    if mesh is not None and mesh.size > 1:
        return Trainer(wl, train, val, cfg, mesh=mesh)
    return Trainer(wl, train, val, cfg)


def _fit(wl, train, val, args, pipeline: str = "", mesh=None):
    trainer = _trainer(wl, train, val, _train_cfg(args, pipeline), mesh)
    return _graft_init_from(trainer, args).fit(_args_dump(args))


def _run_expert(args, factories):
    """bdd / finetune-carla: the task's factory; segmentation and drivable
    take no box cap and run no matcher."""
    wl = W.bdd_expert_workload(args.task, bbox_loss_weight=args.bbox_loss_weight,
                               matcher=args.matcher, dtype=_dtype(args), remat=args.remat,
                               qat=args.qat, augment=args.augment)
    kw = {"box_cap": args.box_cap} if args.task == "detection" else {}
    mesh = _mesh(args)
    return _fit(wl, *_sized_loaders(factories[args.task], args, mesh, **kw), args, mesh=mesh)


def cmd_bdd(args):
    from automoe_tpu_torch.data import (
        get_bdd_detection_loader,
        get_bdd_drivable_loader,
        get_bdd_segmentation_loader,
    )

    return _run_expert(args, {"detection": get_bdd_detection_loader,
                              "segmentation": get_bdd_segmentation_loader,
                              "drivable": get_bdd_drivable_loader})


def cmd_finetune_carla(args):
    from automoe_tpu_torch.data import (
        get_carla_detection_loader,
        get_carla_drivable_loader,
        get_carla_segmentation_loader,
    )

    return _run_expert(args, {"detection": get_carla_detection_loader,
                              "segmentation": get_carla_segmentation_loader,
                              "drivable": get_carla_drivable_loader})


def cmd_nuscenes(args):
    from automoe_tpu_torch.data import get_nuscenes_loader

    _no_effect(args, "nuscenes", {"augment": "the JAX nuScenes workload has no "
                                             "augmentation"})
    wl = W.nuscenes_workload(num_queries=args.num_queries, bbox_dim=7,
                             use_lidar=args.use_lidar, use_tnet=args.use_tnet,
                             fusion=args.fusion, bbox_loss_weight=args.bbox_loss_weight,
                             matcher=args.matcher, dtype=_dtype(args), remat=args.remat,
                             qat=args.qat)
    mesh = _mesh(args)
    return _fit(wl, *_sized_loaders(get_nuscenes_loader, args, mesh, lidar_cap=args.lidar_cap,
                                    box_cap=args.box_cap), args, mesh=mesh)


def cmd_nuscenes_2d(args):
    from automoe_tpu_torch.data import get_carla_detection_loader

    wl = W.carla_nuscenes_2d_workload(num_queries=args.num_queries,
                                      bbox_loss_weight=args.bbox_loss_weight,
                                      dtype=_dtype(args), remat=args.remat, qat=args.qat,
                                      augment=args.augment)
    mesh = _mesh(args)
    return _fit(wl, *_sized_loaders(get_carla_detection_loader, args, mesh,
                                    box_cap=args.box_cap), args, mesh=mesh)


def cmd_policy(args):
    import torch

    from automoe_tpu_torch.data import get_carla_sequence_loader
    from automoe_tpu_torch.utils import resolve_device

    _no_effect(args, "policy", {
        "remat": "EasyBackbone is 4 convs; nothing worth checkpointing",
        "qat": "int8 serving quantizes only the expert trunks; the policy head stays bf16",
        "augment": "expert pipelines only"})
    mesh = _mesh(args) if args.epochs else None
    if args.pp_microbatches > 0:
        if args.trunk_depth <= 0:
            raise SystemExit("--pp-microbatches needs --trunk-depth > 0 (only the deep trunk "
                             "is stage-partitionable)")
        if args.epochs and (mesh is None or mesh.shape["model"] < 2):
            raise SystemExit("--pp-microbatches needs --model-axis > 1")
        if args.epochs and args.trunk_depth % mesh.shape["model"]:
            raise SystemExit(f"--trunk-depth {args.trunk_depth} must divide by "
                             f"--model-axis {mesh.shape['model']}")
    wl = W.policy_workload(horizon=args.horizon, context_dim=args.context_dim,
                           image_size=args.image_size, dtype=_dtype(args),
                           trunk_depth=args.trunk_depth, trunk_width=args.trunk_width,
                           pipeline_mesh=mesh if args.epochs else None,
                           pipeline_microbatches=args.pp_microbatches if args.epochs else 0)
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
    train, val = _sized_loaders(get_carla_sequence_loader, args, mesh, horizon=args.horizon)
    return _fit(wl, train, val, args, "policy", mesh=mesh)


def _gating_guards(args) -> None:
    """The JAX CLI's refusals for the feature cache, the resident loader
    and expert parallelism's mesh."""
    if args.cache_expert_features:
        if args.unfreeze_experts:
            raise SystemExit("--cache-expert-features requires frozen experts (the cache is "
                             "one eval pass over fixed weights); drop --unfreeze-experts")
        if args.parallelism == "ep":
            raise SystemExit("--cache-expert-features removes the expert compute that "
                             "--parallelism ep distributes; pick one")
        if args.spatial:
            raise SystemExit("--cache-expert-features is exclusive with --spatial (spatial "
                             "sharding targets the expert trunks' image compute, which the "
                             "cache skips; the cached step's remaining image consumer — the "
                             "policy backbone — is below SP's useful size)")
    if args.device_resident:
        if not args.cache_expert_features:
            raise SystemExit("--device-resident requires --cache-expert-features (the "
                             "resident working set = frames + pooled features + control "
                             "targets; without the cache the expert trunks would also need "
                             "lidar and recompute per epoch — use the host loader there)")
        if args.grad_accum > 1:
            raise SystemExit("--device-resident doesn't compose with --grad-accum (the "
                             "resident loader pre-groups for steps_per_call; raise "
                             "--batch-size instead)")
    if args.parallelism == "ep":
        if args.no_mesh:
            raise SystemExit("--parallelism ep requires a device mesh")
        if args.spatial:
            raise SystemExit("--spatial is exclusive with --parallelism ep (both consume the "
                             "'model' mesh axis)")
        if args.tp_min_dim > 0:
            raise SystemExit("--tp-min-dim is exclusive with --parallelism ep (both consume "
                             "the 'model' mesh axis)")


def cmd_gating(args):
    from automoe_tpu_torch.ckpt import load_expert_checkpoints
    from automoe_tpu_torch.configs import default_model_config, load_model_config
    from automoe_tpu_torch.data import get_carla_sequence_loader

    cfg = load_model_config(args.model_config) if args.model_config else default_model_config()
    _no_effect(args, "gating", {
        "remat": "the experts are frozen; the backward never crosses their backbones",
        "qat": "experts are frozen pre-trained weights here; QAT belongs to the expert "
               "trainers whose checkpoints feed this stage",
        "augment": "expert pipelines only"})
    loss_cfg = json.loads(args.loss_config or "{}")
    if args.parallelism == "ep":
        from automoe_tpu_torch.parallel.ep import ep_gating_workload

        n, E = _world_size(args), len(cfg.experts)
        if n % E:
            raise SystemExit(f"--parallelism ep needs device count divisible by {E} experts "
                             f"(have {n})")
        mesh = _mesh(args, data=n // E, model=E)
        wl = ep_gating_workload(cfg, mesh, loss_config=loss_cfg, image_size=args.image_size,
                                freeze_experts=not args.unfreeze_experts, dtype=_dtype(args))
    else:
        mesh = _mesh(args)
        wl = W.gating_workload(cfg, loss_config=loss_cfg,
                               freeze_experts=not args.unfreeze_experts, dtype=_dtype(args),
                               cache_features=args.cache_expert_features)
    train, val = _sized_loaders(get_carla_sequence_loader, args, mesh,
                                horizon=cfg.policy.num_waypoints)
    trainer = _graft_init_from(_trainer(wl, train, val, _train_cfg(args, "gating"), mesh),
                               args)
    # expert checkpoints seed fresh state only: after a real restore,
    # grafting them again would roll the experts' BatchNorm statistics
    # (or, with --unfreeze-experts, their trained weights) back on every
    # relaunch; a relaunch that found nothing to restore still grafts
    if args.expert_ckpts and not trainer.resumed:
        with trainer.unsharded():  # tensor parallelism's slices whole, by name
            load_expert_checkpoints(trainer.model, cfg, args.expert_ckpts.split(","))
        # the JAX CLI leaves its EMA at the random init here; the port's
        # starts at the grafted weights, so serve --ema gets the experts
        trainer.reset_ema()
    if args.cache_expert_features:
        # one eval pass over each split after the graft or restore (the cache
        # must see the final frozen weights); later steps skip the trunks
        from automoe_tpu_torch.train.feature_cache import attach_pooled_features

        # several ranks share the pass over their data ranks; rank 0 writes
        root = args.packed_root or args.data_root
        attach_pooled_features(trainer.model, train, val, batch_size=args.batch_size,
                               cache_dir=args.feature_cache_dir,
                               cache_tags=[f"{root}:train", f"{root}:val"], mesh=trainer.mesh,
                               state_dict=trainer.whole_state_dict())
    if args.device_resident:
        # the cached epoch (frames included: the policy head trains its own
        # backbone through them) staged on the card once, fed as groups of
        # --steps-per-call batches; rebind rebuilds the schedule for the
        # trimmed length. Validation stays on the host loader, whose padded
        # tail keeps every val sample.
        # Several ranks: data rank d stages only its shard (the sharded
        # sampler's slice rule), and each epoch's permutation is exchanged
        # over the data group (data/device_resident.py).
        from automoe_tpu_torch.data.device_resident import DeviceEpochLoader

        m = trainer.mesh
        indices = (range(m.data_index, len(train.dataset), m.shape["data"])
                   if m is not None and m.shape["data"] > 1 else None)
        trainer.rebind_train_loader(DeviceEpochLoader.from_dataset(
            train.dataset, batch_size=args.batch_size, group_size=max(1, args.steps_per_call),
            seed=args.seed, device=trainer.device, mesh=m, indices=indices))
    return trainer.fit(_args_dump(args))


PRESET_DIR = Path(__file__).resolve().parents[1] / "configs" / "presets"


def _expand_preset(argv):
    """`preset <name-or-path> [overrides...]` → the subcommand's argv.

    Presets are JSON run configs (configs/presets/): `pipeline` names the
    subcommand, every other key a flag (true booleans as bare flags, false
    ones dropped, dicts as JSON). Trailing args override preset keys
    (argparse: the last one wins). `--list` / `-l`, or no name, prints the
    presets' names and exits."""
    if len(argv) < 2 or argv[1] in ("--list", "-l"):
        for f in sorted(PRESET_DIR.glob("*.json")):
            print(f.stem)
        raise SystemExit(0)
    path = Path(argv[1])
    if not path.exists():
        path = PRESET_DIR / argv[1]
        if not path.suffix:
            path = path.with_suffix(".json")
    cfg = json.loads(path.read_text())
    out = [cfg.pop("pipeline")]
    for key, val in cfg.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(val, bool):
            if val:
                out.append(flag)
        elif isinstance(val, dict):
            out += [flag, json.dumps(val)]
        else:
            out += [flag, str(val)]
    return out + list(argv[2:])


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    if argv and argv[0] == "preset":
        argv = _expand_preset(argv)
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

    pn = sub.add_parser("nuscenes")
    pn.add_argument("--num-queries", type=int, default=100)
    pn.add_argument("--use-lidar", action="store_true")
    pn.add_argument("--use-tnet", action="store_true")
    pn.add_argument("--fusion", choices=["concat", "sum"], default="concat")
    pn.add_argument("--lidar-cap", type=int, default=8192)
    pn.add_argument("--bbox-loss-weight", type=float, default=5.0)
    _add_common(pn)
    pn.set_defaults(fn=cmd_nuscenes, epochs=50, batch_size=32, learning_rate=1e-4,
                    weight_decay=1e-5)

    p2 = sub.add_parser("nuscenes-2d")
    p2.add_argument("--num-queries", type=int, default=196)
    p2.add_argument("--bbox-loss-weight", type=float, default=1.0)
    _add_common(p2)
    p2.set_defaults(fn=cmd_nuscenes_2d, epochs=10, batch_size=16, learning_rate=2e-4,
                    weight_decay=1e-5)

    pp = sub.add_parser("policy")
    pp.add_argument("--horizon", type=int, default=8)
    pp.add_argument("--context-dim", type=int, default=0)
    pp.add_argument("--trunk-depth", type=int, default=0,
                    help="N>0 swaps EasyBackbone for the depth-scalable residual GroupNorm "
                         "trunk (models/deep_policy.py) with N blocks")
    pp.add_argument("--trunk-width", type=int, default=128,
                    help="channels of the deep trunk's blocks")
    pp.add_argument("--pp-microbatches", type=int, default=0,
                    help="M>0 pipelines the deep trunk over the mesh's 'model' axis, "
                         "GPipe-style with M microbatches (parallel/pp.py; needs "
                         "--trunk-depth divisible by --model-axis > 1)")
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
    pg.add_argument("--cache-expert-features", action="store_true",
                    help="precompute the frozen experts' pooled gating features in one eval "
                         "pass, then train without running the expert trunks (frozen-BN "
                         "semantics: train/feature_cache.py)")
    pg.add_argument("--device-resident", action="store_true",
                    help="stage the cached epoch on the card once and train from "
                         "pre-grouped device batches (no per-step host-to-device copy; "
                         "needs --cache-expert-features; best with --steps-per-call K)")
    pg.add_argument("--feature-cache-dir", default=None,
                    help="keep the pooled-feature cache here (keyed by the frozen expert "
                         "weights and the dataset); a re-run loads it instead of running "
                         "the eval pass again")
    pg.add_argument("--parallelism", choices=["dp", "ep"], default="dp",
                    help="dp: data parallel over the mesh; ep: one expert per 'model'-axis "
                         "rank (parallel/ep.py; needs a world divisible by the experts)")
    _add_common(pg)
    pg.set_defaults(fn=cmd_gating, epochs=100, batch_size=8, learning_rate=1e-4,
                    weight_decay=1e-4)

    args = p.parse_args(argv)
    _world_guards(args)
    from automoe_tpu_torch.parallel.mesh import clear_mesh, init_world

    try:
        if args.multihost:
            _, dev = init_world(args.coordinator, args.num_processes, args.process_id,
                                args.device)
            args.device = str(dev)
        return args.fn(args)
    finally:
        clear_mesh()


if __name__ == "__main__":
    main()
