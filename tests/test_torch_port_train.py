"""The port's detection training path against the JAX package on the CPU:
the optimizer and its schedules against optax (rtol 1e-6), BatchNorm in
train mode, a 3-step SGD trajectory of the detection workload from
carried-across weights (auction_kernel against auction_pallas), the loader's
batch order, and `automoe-train-torch finetune-carla` on a tiny cache.
The JAX trajectory is computed once per module."""
from __future__ import annotations

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
HW, B, NBOX, N_STEPS = 64, 2, 4, 3
LR = 1e-3


def _grads(rng, shapes, scale):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("optimizer,schedule,frozen", [
    ("adamw", "cosine", None),
    ("sgd", "cosine", None),
    ("adamw", "constant", "b"),
    ("adamw", "cosine_per_epoch", None),
])
def test_optimizer_matches_optax(optimizer, schedule, frozen):
    """3 steps of the JAX package's make_optimizer (optax) and the port's on
    the same params and gradients: lr and params within rtol 1e-6. The
    gradient scale alternates around the clip norm, so both branches of
    the clip run."""
    from automoe_tpu.train.state import make_optimizer as jax_make_optimizer

    from automoe_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(7)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mask = {k: k != frozen for k in shapes} if frozen else None
    kw = dict(learning_rate=3e-2, weight_decay=0.1, total_steps=5, grad_clip=1.0,
              schedule=schedule, optimizer=optimizer, steps_per_epoch=2)
    tx = jax_make_optimizer(trainable_mask=mask, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.items(), trainable_mask=mask, **kw)
    for step, scale in enumerate((1.0, 0.05, 0.5)):
        g = _grads(rng, shapes, scale)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {step}")
    if frozen:
        np.testing.assert_array_equal(tp[frozen].detach().numpy(), params[frozen])


@pytest.mark.parametrize("schedule", ["cosine", "cosine_per_epoch", "constant"])
def test_schedule_matches_optax(schedule):
    import optax

    from automoe_tpu_torch.train.state import make_optimizer

    opt = make_optimizer([], learning_rate=2e-4, total_steps=12, eta_min=1e-5,
                         schedule=schedule, steps_per_epoch=4)
    base = optax.cosine_decay_schedule(2e-4, 12, alpha=1e-5 / 2e-4)
    for t in range(15):
        want = {"cosine": base(t), "cosine_per_epoch": base(t // 4), "constant": 2e-4}[schedule]
        np.testing.assert_allclose(opt.lr_at(t), float(want), rtol=1e-6)


def test_batchnorm_train_mode_matches_jax():
    """torch's BatchNorm2d in train mode is the JAX package's TorchBatchNorm:
    biased variance in the normalisation, unbiased variance into the
    running stats with momentum 0.1 (JAX computes E[x²]−E[x]²: ~1e-6)."""
    from automoe_tpu.models.norm import TorchBatchNorm

    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 5, 5, 8)) * 2 + 1).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    mean, var = rng.normal(size=8).astype(np.float32), rng.uniform(0.5, 2, 8).astype(np.float32)
    bn = TorchBatchNorm(use_running_average=False)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean, "var": var}}, x, mutable=["batch_stats"])
    tb = torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(scale))
        tb.bias.copy_(torch.from_numpy(bias))
        tb.running_mean.copy_(torch.from_numpy(mean))
        tb.running_var.copy_(torch.from_numpy(var))
    got = tb.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5)


def _detection_batches(seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        xy1 = rng.uniform(0.05, 0.45, (B, NBOX, 2))
        xy2 = rng.uniform(0.55, 0.95, (B, NBOX, 2))
        labels = rng.integers(0, 10, (B, NBOX)).astype(np.int32)
        labels[0, -1] = -1  # one padded slot
        boxes = np.concatenate([xy1, xy2], -1).astype(np.float32)
        boxes[0, -1] = 0.0
        out.append({"image": rng.normal(size=(B, HW, HW, 3)).astype(np.float32),
                    "bboxes": boxes, "labels": labels})
    return out


def _losses(jsonl) -> list:
    recs = map(json.loads, jsonl.read_text().splitlines())
    return [r["train/loss"] for r in recs if "train/loss" in r]


@pytest.fixture(scope="module")
def trajectories(module_tmp):
    """N_STEPS SGD steps of the detection workload in both packages from
    the same weights: JAX with matcher auction_pallas (interpret mode),
    the port with auction_kernel (its plain version on the CPU)."""
    from automoe_tpu.train.loop import TrainConfig as JaxConfig
    from automoe_tpu.train.loop import Trainer as JaxTrainer
    from automoe_tpu.train.state import TrainState
    from automoe_tpu.train.workloads import bdd_expert_workload as jax_workload

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    tmp = module_tmp("traj")
    batches = _detection_batches()
    wl = jax_workload("detection", image_size=HW, box_cap=NBOX, matcher="auction_pallas")
    jtr = JaxTrainer(wl, batches, batches, JaxConfig(
        epochs=1, learning_rate=LR, weight_decay=0.0, optimizer="sgd", run_name="j",
        ckpt_root=str(tmp / "ckpt"), runs_root=str(tmp / "runs"), log_every=1,
        max_inflight=0))
    rng = np.random.default_rng(5)
    init = {"params": _perturb_norms(jax.device_get(jtr.state.params), rng),
            "batch_stats": _perturb_norms(jax.device_get(jtr.state.batch_stats), rng)}
    jtr.state = TrainState.create(params=init["params"], tx=jtr.state.tx,
                                  batch_stats=init["batch_stats"])
    jtr.train_epoch(0)
    jtr.logger.close()
    final = {"params": jax.device_get(jtr.state.params),
             "batch_stats": jax.device_get(jtr.state.batch_stats)}

    ptr = Trainer(bdd_expert_workload("detection", matcher="auction_kernel"),
                  batches, batches, TrainConfig(epochs=1, learning_rate=LR, weight_decay=0.0,
                                                optimizer="sgd", run_name="p",
                                                runs_root=str(tmp / "runs"), device="cpu",
                                                log_every=1))
    ptr.model.load_state_dict(expert_state_dict_from_jax(init, "detection"), strict=True)
    ptr.train_epoch(0)
    ptr.logger.close()
    return {
        "jax_losses": _losses(tmp / "runs" / "bdd_detection_j" / "metrics.jsonl"),
        "port_losses": _losses(tmp / "runs" / "bdd_detection_p" / "metrics.jsonl"),
        "jax_final": {k: v for k, v in expert_state_dict_from_jax(final, "detection").items()
                      if not k.endswith("num_batches_tracked")},
        "port_final": {k: v.detach() for k, v in ptr.model.state_dict().items()
                       if not k.endswith("num_batches_tracked")},
    }


def test_sgd_trajectory_losses_match_jax(trajectories):
    assert len(trajectories["port_losses"]) == len(trajectories["jax_losses"]) == N_STEPS
    np.testing.assert_allclose(trajectories["port_losses"], trajectories["jax_losses"],
                               rtol=1e-4)


@pytest.mark.parametrize("group", ["backbone.0", "backbone.1", "backbone.4", "backbone.5",
                                   "backbone.6", "backbone.7", "head."])
def test_sgd_trajectory_params_match_jax(trajectories, group):
    """Parameters and BatchNorm running stats after N_STEPS steps, rtol 1e-4
    (atol 1e-6 for elements near zero)."""
    port, want = trajectories["port_final"], trajectories["jax_final"]
    assert set(port) == set(want)
    keys = [k for k in want if k.startswith(group)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_loader_order_matches_jax(tmp_path):
    """The port's loader over a CARLA cache yields the JAX loader's batches,
    padded tail and per-epoch shuffle included."""
    from automoe_tpu.data.factories import get_carla_detection_loader as jax_loader

    from automoe_tpu_torch.data import get_carla_detection_loader
    from automoe_tpu_torch.tools.synth import synth_carla_detection

    root = synth_carla_detection(tmp_path, n_per_split={"train": 7, "val": 5}, size=32,
                                 max_boxes=3)
    for split in ("train", "val"):
        kw = dict(split=split, batch_size=3, num_workers=2, root_dir=str(root), box_cap=4)
        mine, ref = get_carla_detection_loader(**kw), jax_loader(**kw)
        assert len(mine) == len(ref)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(mine), list(ref)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert sorted(a) == sorted(b)
                for k in b:
                    np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_train_cli_seed_sets_the_shuffle(tmp_path):
    """--seed reaches the train loader's shuffle: its first epoch is
    default_rng(seed)'s permutation of the cache."""
    import argparse

    from automoe_tpu_torch.data import get_carla_detection_loader
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import _loaders

    root = synth_carla_detection(tmp_path, n_per_split={"train": 6, "val": 2}, size=32,
                                 max_boxes=2)
    args = argparse.Namespace(batch_size=2, num_workers=1, data_root=str(root), seed=3)
    train, val = _loaders(get_carla_detection_loader, args, box_cap=2)
    order = np.arange(6)
    np.random.default_rng(3).shuffle(order)
    got = np.concatenate([b["image"] for b in train])
    want = np.stack([train.dataset[int(i)]["image"] for i in order])
    np.testing.assert_array_equal(got, want)
    assert not val.sampler.shuffle


def test_train_cli_finetune_carla_on_cpu(tmp_path):
    from automoe_tpu_torch.ops import auction_kernel
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import main

    root = synth_carla_detection(tmp_path / "data", n_per_split={"train": 4, "val": 3},
                                 size=64, max_boxes=3)
    n = auction_kernel.LAUNCHES["auction_solve"]
    res = main(["finetune-carla", "--task", "detection", "--data-root", str(root),
                "--image-size", "64", "--box-cap", "4", "--batch-size", "2", "--epochs", "2",
                "--num-workers", "1", "--runs-root", str(tmp_path / "runs"),
                "--ckpt-root", str(tmp_path / "ckpt"), "--matcher", "auction_kernel",
                "--device", "cpu"])
    assert np.isfinite(res["best_val_loss"])
    assert auction_kernel.LAUNCHES["auction_solve"] == n  # plain version on the CPU
    recs = [json.loads(line) for line in
            (tmp_path / "runs" / "bdd_detection_run" / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in recs if "train/loss_epoch" in r]
    vals = [r for r in recs if "val/loss" in r]
    assert len(epochs) == len(vals) == 2
    assert all(np.isfinite(r["val/avg_iou"]) and np.isfinite(r["val/recall_0.5"])
               for r in vals)


@pytest.mark.parametrize("argv,match", [
    (["nuscenes", "--spatial"], "--spatial needs --model-axis > 1"),
    (["bdd", "--task", "segmentation", "--tp-min-dim", "1"], "--tp-min-dim needs --model-axis > 1"),
    (["bdd", "--task", "detection", "--multihost"], "--multihost needs --coordinator"),
    (["finetune-carla", "--task", "detection", "--model-axis", "2"],
     "mesh 1x2 != 1 devices"),
    # a preset's overrides meet the same checks
    (["preset", "carla_finetune_v5e", "--model-axis", "2"], "mesh 1x2 != 1 devices"),
    (["policy", "--trunk-depth", "4", "--pp-microbatches", "2", "--epochs", "1"],
     "--pp-microbatches needs --model-axis > 1"),
    (["gating", "--cache-expert-features", "--parallelism", "ep"],
     "--cache-expert-features removes the expert compute that --parallelism ep"),
    (["gating", "--parallelism", "ep"],
     r"--parallelism ep needs device count divisible by 4 experts \(have 1\)"),
    (["gating", "--parallelism", "ep", "--no-mesh"], "--parallelism ep requires a device mesh"),
    # the gating guards need only the flags: a refused rank never joins the group
    (["gating", "--cache-expert-features", "--device-resident", "--spatial", "--model-axis",
      "2", "--multihost", "--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0"],
     "--cache-expert-features is exclusive with --spatial"),
    (["gating", "--device-resident", "--multihost", "--coordinator", "127.0.0.1:1",
      "--num-processes", "2", "--process-id", "1"],
     "--device-resident requires --cache-expert-features"),
    (["bdd", "--task", "detection", "--no-mesh", "--multihost", "--coordinator",
      "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"],
     "--no-mesh runs one process with no process group"),
], ids=["subcommand", "task", "flag", "flag-with-value", "preset", "policy-deep-trunk",
        "gating-feature-cache", "gating-ep", "gating-ep-no-mesh",
        "gating-feature-cache-multi-rank", "gating-device-resident-multi-rank",
        "no-mesh-multi-rank"])
def test_train_cli_rejects_what_is_not_ported(argv, match, tmp_path, capsys):
    """The JAX CLI's refusals, with its words (the port has every mode the
    JAX CLI has); none of these reaches a process group."""
    from automoe_tpu_torch.train.cli import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--data-root", str(tmp_path), "--device", "cpu"] if len(argv) > 1
             else argv)
    assert e.value.code != 0
    # argparse's errors go to stderr; the CLI's own refusals are the exit message
    said = str(e.value.code) + capsys.readouterr().err
    assert re.search(match, said), said


def test_serve_cli_refuses_data_parallel(tmp_path):
    """The JAX server's refusal: --data-parallel needs a live model, not a
    bundle's programs."""
    from automoe_tpu_torch.serving.cli import main

    with pytest.raises(SystemExit) as e:
        main(["--data-parallel", "--bundle", str(tmp_path), "--device", "cpu"])
    assert "--data-parallel needs a live model" in str(e.value.code)


def test_default_device_and_matcher(monkeypatch, tmp_path):
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import main
    from automoe_tpu_torch.train.workloads import default_matcher

    assert default_matcher("cuda") == "auction_kernel"
    assert default_matcher("cpu") == "auction"
    root = synth_carla_detection(tmp_path, n_per_split={"train": 2, "val": 2}, size=32,
                                 max_boxes=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["finetune-carla", "--task", "detection", "--data-root", str(root),
              "--image-size", "32", "--batch-size", "2", "--epochs", "1"])


def test_train_cli_checks_image_size_against_the_cache(tmp_path):
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import main

    root = synth_carla_detection(tmp_path, n_per_split={"train": 2, "val": 2}, size=32,
                                 max_boxes=2)
    with pytest.raises(SystemExit, match="32x32"):
        main(["finetune-carla", "--task", "detection", "--data-root", str(root),
              "--image-size", "64", "--batch-size", "2", "--device", "cpu"])
