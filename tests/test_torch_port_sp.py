"""The port's spatial partitioning (automoe_tpu_torch/parallel/sp.py: the
ResNet trunks' maps split by height with hand-written halo exchanges)
against the JAX package's (GSPMD's halos under `with_spatial_gather`) on
the CPU, each rank a gloo subprocess (tests/torch_port_ranks.py); every
JAX reference comes from the one module fixture, on a
MeshSpec(data=1, model=2) mesh of conftest's CPU devices:

* the halo arithmetic of each trunk layer at 32 x 32 and 72 x 32 over 2
  shards (rows from each neighbour, and where the maps are gathered);
* `bdd_expert_workload("drivable")` with --spatial on 2 ranks (model 2),
  SGD, at 32 x 32 and at 72 x 32 (its 9-row layer2 output does not split
  over 2, so the port gathers there), with tests/test_sp.py's tolerances
  (and the 32 x 32 step with remat equal to it, rtol 1e-5 / atol 1e-6):
  one step, the loss rtol 1e-5 and every parameter and BatchNorm
  statistic atol 1e-5; three steps, the losses rtol 5e-3; at 32 x 32 the
  eval-mode loss before training rtol 1e-5 / atol 1e-6;
* a split rank keeps less for the backward than the whole trunk: the
  detection step at 64 x 64 (tools/sp_memory.py on the CPU, 2 ranks)
  saves under 0.7 of the whole step's bytes a rank (the split convs and
  pools keep their shard and halo rows, not the concatenation: keeping it
  gives ~0.82; layer3/4 and the head run whole at this size);
* JAX's "divisible" error and its SP guards, in the Trainer and the CLI.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
from tests.torch_port_ranks import run_ranks

LR, B = 1e-3, 8
SIZES = {"32x32": (32, 32), "72x32": (72, 32)}


def _seg_batches(n, hw, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(b, *hw, 3)).astype(np.float32),
             "mask": rng.integers(0, 3, (b, *hw)).astype(np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def ref(module_tmp):
    """JAX's spatial runs at each size: one step (loss, parameters,
    BatchNorm statistics), three steps (losses), the eval loss; and the
    port's 2-rank runs of the same."""
    from automoe_tpu.parallel import MeshSpec, make_mesh
    from automoe_tpu.parallel.sp import shard_batch_spatial, with_spatial_gather
    from automoe_tpu.train import TrainState, make_optimizer, make_train_step
    from automoe_tpu.train.step import make_eval_step
    from automoe_tpu.train.workloads import bdd_expert_workload

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax

    out = {"dir": module_tmp("sp_ref")}
    mesh = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    wl = bdd_expert_workload("drivable", image_size=32)
    variables = jax.device_get(wl.init_variables(jax.random.key(0)))
    loss_fn = with_spatial_gather(wl.loss_fn, mesh)
    step = make_train_step(loss_fn, mesh=mesh, batch_shardings=None)
    evaluate = make_eval_step(loss_fn, mesh=mesh, batch_shardings=None)
    torch.save({"model_state_dict": expert_state_dict_from_jax(variables, "drivable")},
               out["dir"] / "init.pt")
    specs = []
    for name, hw in SIZES.items():
        batches = _seg_batches(3, hw)

        def fresh():
            tx = make_optimizer(learning_rate=LR, weight_decay=0.0, total_steps=3,
                                optimizer="sgd")
            return TrainState.create(params=variables["params"], tx=tx,
                                     batch_stats=variables["batch_stats"])

        res = {}
        if name == "32x32":  # one eval compile
            res["eval0"] = float(evaluate(fresh(), shard_batch_spatial(batches[0], mesh),
                                          jax.random.key(1))["loss"])
        for n in (1, 3):
            state, losses = fresh(), []
            for bt in batches[:n]:
                state, m = step(state, shard_batch_spatial(bt, mesh), jax.random.key(1))
                losses.append(float(m["loss"]))
            res[f"losses{n}"] = losses
            if n == 1:
                res["want1"] = expert_state_dict_from_jax(jax.device_get(
                    {"params": state.params, "batch_stats": state.batch_stats}), "drivable")
            torch.save(batches[:n], out["dir"] / f"{name}_{n}.pt")
            specs.append({"workload": "bdd_expert_workload",
                          "workload_kw": {"task": "drivable"},
                          "init": str(out["dir"] / "init.pt"),
                          "batches": str(out["dir"] / f"{name}_{n}.pt"), "data": 1, "model": 2,
                          "out": str(out["dir"] / f"{name}_{n}"),
                          "config": {"learning_rate": LR, "weight_decay": 0.0,
                                     "optimizer": "sgd", "epochs": 1, "spatial": True}})
        out[name] = res
    # the 32x32 step again with remat: the trunk's blocks recomputed in the
    # backward, their halo exchanges included
    specs.append({**specs[0], "workload_kw": {"task": "drivable", "remat": True},
                  "out": str(out["dir"] / "remat")})
    ranks = run_ranks("mode_run", 2, out["dir"] / "ranks", *specs)
    for i, name in enumerate(SIZES):
        out[name]["port1"], out[name]["port3"] = ranks[0][2 * i], ranks[0][2 * i + 1]
        out[name]["rank1_state"] = ranks[1][2 * i]["state"]
    out["remat"] = ranks[0][-1]
    return out


def _plan(M=2, m=0, min_rows=4):
    from automoe_tpu_torch.parallel.sp import _Plan

    return _Plan(types.SimpleNamespace(shape={"data": 1, "model": M}, model_index=m), min_rows)


@pytest.mark.parametrize("H,want", [
    (32, {"conv1": (3, 2, 8), "pool": (1, 0, 4), "layer1": (1, 1, 4), "layer2": None}),
    (72, {"conv1": (3, 2, 18), "pool": (1, 0, 9), "layer1": (1, 1, 9), "layer2": None}),
    (256, {"conv1": (3, 2, 64), "pool": (1, 0, 32), "layer1": (1, 1, 32),
           "layer2": (1, 0, 16), "layer2_ds": (0, 0, 16), "layer3": (1, 0, 8),
           "layer4": (1, 0, 4)}),
], ids=["32", "72", "256"])
def test_halo_rows(H, want):
    """Rows from the rank before and after, and output rows a shard, of
    each trunk layer over 2 shards; None where the map is gathered first
    (32: layer2's 4 output rows are below 4 a shard; 72: its 9 rows do not
    split over 2; 256: the whole trunk runs split)."""
    from automoe_tpu_torch.models.resnet import ResNet18Backbone

    bb, sp = ResNet18Backbone(), _plan()
    h = H // 2
    got = {"conv1": sp.halo_rows(bb[0], h)}
    h = got["conv1"][2]
    got["pool"] = sp.halo_rows(bb[3], h)
    h = got["pool"][2]
    got["layer1"] = sp.halo_rows(bb[4][0].conv1, h)
    for name, layer in (("layer2", bb[5]), ("layer3", bb[6]), ("layer4", bb[7])):
        if name not in want:
            break
        got[name] = sp.halo_rows(layer[0].conv1, h)
        if name == "layer2" and got[name] is not None:
            got["layer2_ds"] = sp.halo_rows(layer[0].downsample[0], h)
        if got[name] is None:
            break
        h = got[name][2]
    assert got == want
    assert sp.block_split(bb[4][0], want["layer1"][2], True)
    assert not sp.block_split(bb[4][0], want["layer1"][2], False)


@pytest.mark.parametrize("size", list(SIZES))
def test_sp_one_step_matches_jax(ref, size):
    r = ref[size]
    port = r["port1"]
    np.testing.assert_allclose(port["losses"], r["losses1"], rtol=1e-5)
    for k, want in r["want1"].items():
        if k.endswith("num_batches_tracked"):  # JAX counts no BatchNorm steps
            continue
        np.testing.assert_allclose(port["state"][k].numpy(), want.numpy(), atol=1e-5,
                                   err_msg=k)
        assert torch.equal(port["state"][k], r["rank1_state"][k]), k  # ranks agree


@pytest.mark.parametrize("size", list(SIZES))
def test_sp_trajectory_matches_jax(ref, size):
    r = ref[size]
    assert len(r["port3"]["losses"]) == 3
    np.testing.assert_allclose(r["port3"]["losses"], r["losses3"], rtol=5e-3)


def test_sp_remat_equals_plain_step(ref):
    plain, remat = ref["32x32"]["port1"], ref["remat"]
    np.testing.assert_allclose(remat["losses"], plain["losses"], rtol=1e-6)
    for k, v in plain["state"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(remat["state"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_sp_eval_matches_jax(ref):
    r = ref["32x32"]
    np.testing.assert_allclose(r["port1"]["eval0"], r["eval0"], rtol=1e-5, atol=1e-6)


def test_sp_rank_saves_less_than_the_whole_trunk():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-m", "automoe_tpu_torch.tools.sp_memory", "--device", "cpu",
         "--size", "64", "--batch", "2"], capture_output=True, text=True, timeout=240,
        env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    whole = [r for r in runs if r["mode"] == "whole"]
    split = [r for r in runs if r["mode"] == "split"]
    assert len(whole) == 1 and sorted(r["rank"] for r in split) == [0, 1], runs
    for r in split:
        assert "_HaloConvBackward" in r["saved_mib_by_node"], r
        assert r["saved_mib"] < 0.7 * whole[0]["saved_mib"], (r["saved_mib"], whole[0])


def test_spatial_requires_divisible_height():
    from automoe_tpu_torch.parallel.sp import check_spatial_batch, spatial_model

    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4}, model_index=0)
    with pytest.raises(ValueError, match=r"spatial partitioning needs H \(30\) divisible by "
                                         r"the 'model' axis \(4\)"):
        check_spatial_batch({"image": np.zeros((4, 30, 32, 3), np.float32)}, mesh)
    check_spatial_batch({"image": np.zeros((4, 32, 32, 3), np.float32),
                         "mask": np.zeros((4, 30, 32), np.int32)}, mesh)  # only images
    with pytest.raises(ValueError, match="min_rows_per_shard must be >= 1"):
        spatial_model(torch.nn.Identity(), mesh, min_rows_per_shard=0)


def test_trainer_spatial_guards():
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    wl = bdd_expert_workload("drivable")
    with pytest.raises(ValueError, match="model"):
        Trainer(wl, [], None, TrainConfig(spatial=True),
                mesh=types.SimpleNamespace(shape={"data": 8, "model": 1}))
    with pytest.raises(ValueError, match="model"):
        Trainer(wl, [], None, TrainConfig(spatial=True), mesh=None)
    with pytest.raises(ValueError, match="exclusive"):
        Trainer(wl, [], None, TrainConfig(spatial=True, steps_per_call=2),
                mesh=types.SimpleNamespace(shape={"data": 2, "model": 4}))


@pytest.mark.parametrize("argv,match", [
    (["bdd", "--task", "drivable", "--spatial", "--no-mesh"], "--spatial requires a device mesh"),
    (["bdd", "--task", "drivable", "--spatial"], "--spatial needs --model-axis > 1"),
    (["gating", "--cache-expert-features", "--spatial"],
     "--cache-expert-features is exclusive with --spatial"),
    (["gating", "--parallelism", "ep", "--spatial"],
     r"--spatial is exclusive with --parallelism ep \(both consume the 'model' mesh axis\)"),
], ids=["no-mesh", "model-axis", "feature-cache", "ep"])
def test_train_cli_spatial_guards(argv, match, tmp_path):
    from automoe_tpu_torch.train.cli import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--data-root", str(tmp_path), "--device", "cpu"])
    assert re.search(match, str(e.value.code)), e.value.code
