"""Multi-rank runs of the port on the CPU for its parallel tests: each rank
is a subprocess that joins a gloo world on a free localhost port (the
JAX package's tests/test_multihost.py launches its processes the same
way) and runs one of the functions below, which import torch and the
port only. `run_ranks` joins every rank with a timeout of its own, so a
stuck rendezvous fails the test instead of hanging the suite.

A rank function takes (rank, world, coordinator, out_dir, *args) and
returns a dict of tensors and numbers, which `run_ranks` hands back per
rank.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn: str, world: int, out_dir, *args, timeout: float = RANK_TIMEOUT_S,
              ) -> List[Dict[str, Any]]:
    """fn (a name in this module) on `world` gloo ranks; their results in
    rank order. A rank that fails or outlives `timeout` fails the call,
    with every rank's output in the message."""
    import torch

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    coordinator = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from tests.torch_port_ranks import _rank_main; _rank_main()",
         fn, str(r), str(world), coordinator, str(out_dir), json.dumps(list(args))],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    logs, failed = [], False
    for p in procs:
        try:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            failed = True
            p.kill()
            logs.append(p.communicate()[0] + f"\n[rank timed out after {timeout} s]")
        failed = failed or p.returncode != 0
    if failed:
        for p in procs:
            p.kill()
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main() -> None:
    import torch

    torch.set_num_threads(1)
    fn, rank, world, coordinator, out_dir, args = sys.argv[1:7]
    rank, world = int(rank), int(world)
    result = globals()[fn](rank, world, coordinator, Path(out_dir), *json.loads(args))
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def _world(rank: int, world: int, coordinator: str, data: int = -1, model: int = 1):
    from automoe_tpu_torch.parallel.mesh import MeshSpec, init_world, make_mesh

    init_world(coordinator, world, rank, "cpu")
    return make_mesh(MeshSpec(data=data, model=model), device="cpu")


# -- rank functions --------------------------------------------------------

def collectives(rank, world, coordinator, out):
    """Σ, mean, gather and the ring permute over a 1 x world mesh, with the
    gradients their backwards give for loss = Σ w·y (w = rank + 1)."""
    import torch

    from automoe_tpu_torch.parallel.mesh import clear_mesh

    mesh = _world(rank, world, coordinator, data=1, model=world)
    res = {"backend": mesh.backend, "staging": mesh.staging}
    w = float(rank + 1)
    for name in ("sum", "mean", "gather", "permute"):
        x = torch.arange(3.0).mul(rank + 1).requires_grad_(True)
        y = {"sum": lambda: mesh.sum(x, "model"), "mean": lambda: mesh.mean(x, "model"),
             "gather": lambda: mesh.gather(x, "model"),
             "permute": lambda: mesh.permute(x, 1, "model")}[name]()
        (w * y).sum().backward()
        res[name] = (y.detach(), x.grad.clone())
    res["denominator"] = mesh.loss_denominator(torch.tensor(rank + 1))
    clear_mesh()
    return res


def batchnorm(rank, world, coordinator, out, seed):
    """Cross-rank BatchNorm1d/2d on this rank's rows of a seeded global
    batch: outputs, input and affine gradients of Σ y·G, running stats."""
    import numpy as np
    import torch
    from torch import nn

    from automoe_tpu_torch.parallel.batchnorm import convert_batchnorm
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    mesh = _world(rank, world, coordinator)
    res = {}
    for kind, shape in (("2d", (8, 3, 5, 4)), ("1d", (8, 3)), ("1d_seq", (8, 3, 6))):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.normal(2.0, 3.0, size=shape).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        bn = (nn.BatchNorm2d if kind == "2d" else nn.BatchNorm1d)(3)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
        convert_batchnorm(bn, mesh)
        rows = slice(rank * shape[0] // world, (rank + 1) * shape[0] // world)
        xs = x[rows].clone().requires_grad_(True)
        y = bn(xs)
        (y * g[rows]).sum().backward()
        res[kind] = {"y": y.detach(), "dx": xs.grad, "dw": bn.weight.grad,
                     "db": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone(),
                     "count": bn.num_batches_tracked.clone()}
    clear_mesh()
    return res


def train(rank, world, coordinator, out, spec):
    """A Trainer run from `spec` (workload, loader, TrainConfig) on a
    world of `world` data ranks, each reading global_batch / world rows;
    rank 0 returns the per-step losses, the final state and EMA."""
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    mesh = _world(rank, world, coordinator) if world > 1 else None
    trainer = build_trainer(spec, mesh, world)
    trainer.fit()
    res = trainer_result(trainer, spec) if rank == 0 else {}
    clear_mesh()
    return res


def build_trainer(spec, mesh, world: int):
    """The Trainer of a `train` spec (a one-process one with mesh None)."""
    from automoe_tpu_torch import data as D
    from automoe_tpu_torch.train import workloads as W
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer

    kw = dict(root_dir=spec["root"], batch_size=spec["global_batch"] // world,
              num_workers=1, seed=spec["seed"], **spec.get("loader", {}))
    if mesh is not None:
        kw.update(num_shards=mesh.shape["data"], shard_index=mesh.data_index)
    factory = getattr(D, spec["factory"])
    train = factory(split="train", **kw)
    val = factory(split="val", shuffle=False, **kw)
    wl = getattr(W, spec["workload"])(**spec.get("workload_kw", {}))
    cfg = TrainConfig(log_every=1, max_inflight=0, device="cpu", seed=spec["seed"],
                      runs_root=spec["out"] + "/runs", ckpt_root=spec["out"] + "/ckpt",
                      **spec["config"])
    return Trainer(wl, train, val, cfg, mesh=mesh)


def trainer_result(trainer, spec) -> Dict[str, Any]:
    recs = [json.loads(line) for line in
            (Path(spec["out"]) / "runs" / f"{trainer.wl.name}_run" / "metrics.jsonl")
            .read_text().splitlines()]
    ema = trainer.optimizer.ema
    return {"losses": [r["train/loss"] for r in recs if "train/loss" in r],
            "val": [r["val/loss"] for r in recs if "val/loss" in r],
            "state": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
            "ema": None if ema is None else {k: v.clone() for k, v in
                                             ema.state_dict().items()}}


def pipeline(rank, world, coordinator, out, params_file, microbatches, block):
    """pipeline_apply of `block` ('mlp' or 'norm', pp.py's demo stage or an
    rsqrt-norm block that is non-finite at zero) over a 1 x world mesh on
    the file's [S]-stacked params and input: the output, and the reduced
    gradients of mean(y²) for this stage's params and for x."""
    import torch

    from automoe_tpu_torch.parallel.mesh import clear_mesh
    from automoe_tpu_torch.parallel.pp import mlp_block, pipeline_apply, stage_param_sharding

    def norm_block(p, h):
        g = h * torch.rsqrt((h * h).mean(-1, keepdim=True))
        return h + torch.relu(g @ p["w1"] + p["b1"]) @ p["w2"]

    mesh = _world(rank, world, coordinator, data=1, model=world)
    saved = torch.load(params_file, weights_only=False)
    local = {k: v.clone().requires_grad_(True)
             for k, v in stage_param_sharding(mesh)(saved["params"]).items()}
    x = torch.as_tensor(saved["x"]).clone().requires_grad_(True)
    fn = {"mlp": mlp_block, "norm": norm_block}[block]
    y = pipeline_apply(fn, local, x, mesh, microbatches=microbatches)
    res = {"y": y.detach()}
    if block == "mlp":
        (y * y).mean().backward()
        grads = [local[k].grad for k in sorted(local)] + [x.grad]
        mesh.reduce_gradients(grads, [True] * len(local) + [False])
        res["grads"] = dict(zip(sorted(local), grads[:-1]))
        res["dx"] = grads[-1]
    clear_mesh()
    return res


def deep_trunk(rank, world, coordinator, out, state_file, microbatches):
    """The deep policy on the file's weights with its trunk pipelined over
    a 1 x world mesh: outputs, loss and the reduced gradients (this
    rank's stage of the trunk, every other parameter whole)."""
    import torch

    from automoe_tpu_torch.models.deep_policy import DeepTrajectoryPolicy
    from automoe_tpu_torch.parallel.mesh import clear_mesh
    from automoe_tpu_torch.parallel.pp import pp_shard_state

    mesh = _world(rank, world, coordinator, data=1, model=world)
    saved = torch.load(state_file, weights_only=False)
    model = DeepTrajectoryPolicy(**saved["kw"])
    model.load_state_dict(saved["state"])
    stage = pp_shard_state(model, mesh, microbatches=microbatches)
    out_ = model(saved["image"].permute(0, 3, 1, 2), saved.get("context"))
    loss = (out_["waypoints"] ** 2).mean() + (out_["speed"] ** 2).mean()
    loss.backward()
    named = list(model.named_parameters())
    grads = [p.grad for _, p in named]
    mesh.reduce_gradients(grads, [n in stage for n, _ in named])
    res = {"out": {k: v.detach() for k, v in out_.items()}, "loss": loss.detach(),
           "grads": {n: g for (n, _), g in zip(named, grads)}}
    clear_mesh()
    return res


def ep(rank, world, coordinator, out, state_file, data, steps):
    """Expert parallelism on a data x (world / data) mesh from the file's
    AutoMoE weights: the eval forward on this data row's rows of the
    file's batch, then `steps` SGD train steps of the EP gating workload
    (losses, final state)."""
    import torch

    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.models.automoe import AutoMoE
    from automoe_tpu_torch.parallel.ep import make_ep_forward
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    saved = torch.load(state_file, weights_only=False)
    cfg = load_model_config(saved["config"])
    mesh = _world(rank, world, coordinator, data=data, model=world // data)
    rows = slice(mesh.data_index * saved["rows"], (mesh.data_index + 1) * saved["rows"])
    model = AutoMoE(cfg)
    model.load_state_dict(saved["state"])
    res = {"forward": {k: v for k, v in make_ep_forward(cfg, mesh)(
        model, {k: v[rows] for k, v in saved["batch"].items()}).items()
        if torch.is_tensor(v)}}
    if steps:
        res.update(ep_steps(model, mesh, cfg, saved, rows, steps))
    clear_mesh()
    return res


def ep_steps(model, mesh, cfg, saved, rows, steps):
    """`steps` SGD steps of `make_ep_gating_train_step` (experts frozen)."""
    from automoe_tpu_torch.models.automoe import expert_param_mask
    from automoe_tpu_torch.parallel.ep import make_ep_gating_train_step
    from automoe_tpu_torch.train.state import make_optimizer

    mask = expert_param_mask(model.named_parameters())
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    opt = make_optimizer(model.named_parameters(), learning_rate=0.05, total_steps=steps,
                         optimizer="sgd", schedule="constant", trainable_mask=mask)
    opt.shard(mesh)
    step = make_ep_gating_train_step(cfg, mesh)
    model.train()
    losses = [float(step(model, opt, {k: v[rows] for k, v in saved["train_batch"].items()},
                         (7, i))["loss"]) for i in range(steps)]
    return {"losses": losses,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def cli(rank, world, coordinator, out, argv):
    """automoe-train-torch with `argv` as rank `rank` of the world."""
    from automoe_tpu_torch.train.cli import main

    res = main(list(argv) + ["--multihost", "--coordinator", coordinator, "--num-processes",
                             str(world), "--process-id", str(rank)])
    return {"result": res}


def mode_run(rank, world, coordinator, out, *specs):
    """For each spec, a Trainer on a data x model mesh (`spec["data"]`,
    `spec["model"]`, one mesh for all; none for a world of one) over the
    global batches of the file `spec["batches"]`, each data rank taking
    its rows, from the weights of the file `spec["init"]` (if any;
    checkpoints under `spec["ckpt"]`, default <out>/ckpt), with
    TrainConfig(**spec["config"]) (tensor parallelism and spatial
    partitioning among its options). Each result: the eval-mode loss of
    the first batch before training (`eval0`), the split parameters'
    names, the per-step losses and, on rank 0, the state in the
    single-process layout. One spec: its result; several: the list."""
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    mesh = (_world(rank, world, coordinator, data=specs[0]["data"], model=specs[0]["model"])
            if world > 1 else None)
    results = [_mode_trainer(spec, mesh, rank) for spec in specs]
    clear_mesh()
    return results[0] if len(results) == 1 else results


def _mode_trainer(spec, mesh, rank):
    import torch

    from automoe_tpu_torch.train import workloads as W
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer

    D = 1 if mesh is None else mesh.shape["data"]
    d = 0 if mesh is None else mesh.data_index
    batches = []
    for b in torch.load(spec["batches"], weights_only=False):
        n = len(next(iter(b.values())))
        batches.append({k: v[d * n // D:(d + 1) * n // D] for k, v in b.items()})
    wl = getattr(W, spec["workload"])(**spec.get("workload_kw", {}))
    cfg = TrainConfig(log_every=1, max_inflight=0, device="cpu", run_name="run",
                      runs_root=spec["out"] + "/runs",
                      ckpt_root=spec.get("ckpt", spec["out"] + "/ckpt"), **spec["config"])
    trainer = Trainer(wl, batches, batches, cfg, mesh=mesh)
    if spec["init"]:
        trainer.load_variables(spec["init"])
    res = {"eval0": float(trainer.eval_step(trainer.model,
                                            trainer._device_batch(batches[0]))["loss"]),
           "tp_names": sorted(trainer.tp_dims)}
    trainer.fit()
    res.update(trainer_result(trainer, spec) if rank == 0 else {})
    res["state"] = {k: v.detach().clone() for k, v in trainer.whole_state_dict().items()}
    return res


def resident_rows(rank, world, coordinator, out, n, b, k):
    """The sample ids a device-resident loader yields, two epochs, grouped
    and indexed: on this rank of `world` data ranks staging its shard
    range(rank, n, world) with b rows a batch, and in one process staging
    the same flat epoch (the shards in rank order) with world·b rows."""
    import numpy as np

    from automoe_tpu_torch.data.device_resident import DeviceEpochLoader
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    mesh = _world(rank, world, coordinator)
    dataset = [{"id": np.int32(i)} for i in range(n)]
    flat = [i for d in range(world) for i in range(d, n, world)]

    def ids(loader):
        got = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            for g in loader:
                if loader.index_mode:
                    g0 = int(g["__group_index__"])
                    g = {"id": loader.epoch_batches["id"][g0:g0 + k]}
                got.append(g["id"].numpy())
        return got

    res = {}
    for index_mode in (False, True):
        res[f"one_{index_mode}"] = ids(DeviceEpochLoader.from_dataset(
            dataset, batch_size=world * b, group_size=k, device="cpu", indices=flat,
            index_mode=index_mode, verbose=False))
        res[f"rank_{index_mode}"] = ids(DeviceEpochLoader.from_dataset(
            dataset, batch_size=b, group_size=k, mesh=mesh, index_mode=index_mode,
            indices=range(rank, n, world), verbose=False))
    clear_mesh()
    return res


def cli_logged(rank, world, coordinator, out, argv):
    """`cli` with every optimizer step's metrics logged (log_every 1) and
    dropout off: the port draws a data rank's dropout masks from its data
    index, so only a dropout-free run of several ranks equals one
    process."""
    import dataclasses

    import torch

    from automoe_tpu_torch.train import cli as train_cli

    torch.nn.Dropout.forward = lambda self, x: x

    base = train_cli._train_cfg
    train_cli._train_cfg = lambda args, pipeline="": dataclasses.replace(base(args, pipeline),
                                                                         log_every=1)
    return cli(rank, world, coordinator, out, argv)


def cli_flat_of(rank, world, coordinator, out, argv, shards):
    """`cli_logged` in one process whose device-resident loader stages the
    flat epoch `shards` data ranks would assemble: each shard
    range(d, N, shards) cut to the ranks' common count, in rank order."""
    from automoe_tpu_torch.data import device_resident

    base = device_resident.DeviceEpochLoader.from_dataset.__func__

    def flat(cls, dataset, *, indices=None, batch_size, group_size=1, **kw):
        per = batch_size // shards * max(1, group_size)
        n = len(range(shards - 1, len(dataset), shards)) // per * per
        idx = [i for d in range(shards) for i in list(range(d, len(dataset), shards))[:n]]
        return base(cls, dataset, indices=idx, batch_size=batch_size, group_size=group_size,
                    **kw)

    device_resident.DeviceEpochLoader.from_dataset = classmethod(flat)
    return cli_logged(rank, world, coordinator, out, argv)
