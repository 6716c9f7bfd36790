"""The port's tensor parallelism (automoe_tpu_torch/parallel/tp.py) against
the JAX package's on the CPU, each rank a gloo subprocess
(tests/torch_port_ranks.py); every JAX reference comes from the one module
fixture, on conftest's 8-device CPU mesh:

* the parameters the port splits at min_dim 128 over 'model' = 2 are
  exactly those JAX's `state_shardings` shards, mapped through the port's
  names (ckpt/from_jax.py), for the drivable expert, the gating AutoMoE
  and the deep policy (its trunk at width 128);
* `bdd_expert_workload("drivable")` at 32 px, SGD, on 2 ranks (data 1 x
  model 2, --tp-min-dim 128) against JAX's `shard_state` run on a
  MeshSpec(data=1, model=2) mesh from the same weights, with
  tests/test_tp.py's tolerances: the 3 losses rtol 1e-5 / atol 1e-6, the
  parameters after them rtol 1e-4 / atol 1e-6;
* the run's epoch checkpoint holds whole weights, and one process resumes
  it to where the 2-rank run ends (rtol 1e-4 / atol 1e-6);
* `gating --cache-expert-features --tp-min-dim 128 --model-axis 2` on 2
  ranks, with a nuScenes expert whose query table is split (a parameter
  no column-parallel layer computes with, read while the cache's pass
  calls each expert on its own), equals one process: the same cache
  files and fingerprints, the pooled features within rtol 1e-6 / atol
  1e-7 (a split conv sums in another order), losses rtol 1e-5 and
  parameters by
  tests/test_torch_port_parallel_dp.py's AdamW CLI rule (rtol 1e-3 /
  atol 4·lr·steps). The one-process cached step is held against JAX in
  tests/test_torch_port_feature_cache.py, and JAX's cached TP step
  against its unsharded one in tests/test_feature_cache.py;
* JAX's TP guards, in the Trainer and the CLI, with its words.
"""
from __future__ import annotations

import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
from tests.torch_port_ranks import mode_run, run_ranks

#: two experts, the nuScenes one with a [8, 256] query table (split at 128)
GATING_CFG = {
    "experts": [{"type": "drivable", "num_classes": 3},
                {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
                 "use_lidar": False}],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}

MIN_DIM, LR, STEPS, B, S = 128, 1e-3, 3, 8, 32


def _seg_batches(n, b=B, size=S, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(b, size, size, 3)).astype(np.float32),
             "mask": rng.integers(0, 3, (b, size, size)).astype(np.int32)} for _ in range(n)]


def _marks(params, mesh, stats=None):
    """A tree like JAX's variables whose leaves are 1 where
    state_shardings shards the parameter, 0 elsewhere."""
    from jax.sharding import PartitionSpec as P

    from automoe_tpu.parallel.tp import state_shardings

    sh = state_shardings(params, mesh, min_dim=MIN_DIM)
    mark = jax.tree.map(lambda x, s: np.full(np.shape(x), float(s.spec != P()), np.float32),
                        params, sh)
    zeros = jax.tree.map(lambda x: np.zeros(np.shape(x), np.float32), stats or {})
    return {"params": mark, "batch_stats": zeros}


def _marked(sd):
    return sorted(k for k, v in sd.items() if v.numel() and bool((v == 1).all()))


@pytest.fixture(scope="module")
def ref(module_tmp):
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.models.deep_policy import DeepTrajectoryPolicy
    from automoe_tpu.parallel import MeshSpec, make_mesh, shard_batch
    from automoe_tpu.parallel.tp import shard_state
    from automoe_tpu.train import TrainState, make_optimizer, make_train_step
    from automoe_tpu.train.workloads import bdd_expert_workload

    from automoe_tpu_torch.ckpt import (deep_policy_state_dict_from_jax,
                                        expert_state_dict_from_jax, state_dict_from_jax)
    from tests.torch_port_common import make_batch, port_config, small_config

    out = {"dir": module_tmp("tp_ref")}
    mesh42 = make_mesh(MeshSpec(data=4, model=2))
    wl = bdd_expert_workload("drivable", image_size=S)
    variables = jax.device_get(wl.init_variables(jax.random.key(0)))
    out["names"] = {"drivable": _marked(expert_state_dict_from_jax(
        _marks(variables["params"], mesh42, variables["batch_stats"]), "drivable"))}
    cfg = small_config()
    model = create_automoe_model(cfg, fast_gating_pool=True)
    shapes = jax.eval_shape(lambda k: model.init(k, make_batch(0)), jax.random.key(0))
    out["names"]["gating"] = _marked(state_dict_from_jax(
        _marks(shapes["params"], mesh42, shapes["batch_stats"]), port_config(cfg)))
    deep = DeepTrajectoryPolicy(horizon=4, backbone_dim=256, depth=2, width=128, groups=8)
    shapes = jax.eval_shape(lambda k: deep.init(k, np.zeros((1, S, S, 3), np.float32), None),
                            jax.random.key(0))
    out["names"]["deep_policy"] = _marked(deep_policy_state_dict_from_jax(
        _marks(shapes["params"], mesh42)))
    out["config"] = cfg

    # three SGD steps on a (1, 2) mesh with the wide kernels sharded; the
    # schedule spans the two epochs the port's run takes
    mesh12 = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    tx = make_optimizer(learning_rate=LR, weight_decay=0.0, total_steps=2 * STEPS,
                        optimizer="sgd")
    state = TrainState.create(params=variables["params"], tx=tx,
                              batch_stats=variables["batch_stats"])
    state, sh = shard_state(state, mesh12, min_dim=MIN_DIM)
    step = make_train_step(wl.loss_fn, mesh=mesh12, state_sharding=sh)
    batches = _seg_batches(STEPS)
    losses = []
    for bt in batches:
        state, m = step(state, shard_batch(bt, mesh12), jax.random.key(1))
        losses.append(float(m["loss"]))
    final = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    out["losses"] = losses
    out["want"] = expert_state_dict_from_jax(final, "drivable")
    torch.save({"model_state_dict": expert_state_dict_from_jax(variables, "drivable")},
               out["dir"] / "init.pt")
    torch.save(batches, out["dir"] / "batches.pt")
    return out


@pytest.fixture(scope="module")
def tp_run(ref):
    """2 ranks, data 1 x model 2, --tp-min-dim 128: two epochs of the
    three batches, a checkpoint each epoch."""
    spec = _spec(ref, "tp", epochs=2, save_freq=1, tp_min_dim=MIN_DIM)
    return spec, run_ranks("mode_run", 2, ref["dir"] / "tp_ranks", spec)


def _spec(ref, name, init=True, **config):
    return {"workload": "bdd_expert_workload", "workload_kw": {"task": "drivable"},
            "init": str(ref["dir"] / "init.pt") if init else None,
            "batches": str(ref["dir"] / "batches.pt"), "data": 1, "model": 2,
            "out": str(ref["dir"] / name),
            "config": {"learning_rate": LR, "weight_decay": 0.0, "optimizer": "sgd", **config}}


@pytest.mark.parametrize("which", ["drivable", "gating", "deep_policy"])
def test_tp_param_names_match_jax(ref, which):
    from automoe_tpu_torch.models import create_automoe_model
    from automoe_tpu_torch.models.deep_policy import DeepTrajectoryPolicy
    from automoe_tpu_torch.parallel.tp import tp_param_names
    from automoe_tpu_torch.train.workloads import bdd_expert_workload
    from tests.torch_port_common import port_config

    model = {"drivable": lambda: bdd_expert_workload("drivable").build_model(),
             "gating": lambda: create_automoe_model(port_config(ref["config"]),
                                                    fast_gating_pool=True, device="cpu"),
             "deep_policy": lambda: DeepTrajectoryPolicy(horizon=4, backbone_dim=256, depth=2,
                                                         width=128, groups=8)}[which]()
    got = tp_param_names(model, 2, MIN_DIM)
    assert got, "no parameter split at min_dim 128: the rule is dead"
    assert got == ref["names"][which]
    assert tp_param_names(model, 1, MIN_DIM) == []  # M = 1 splits nothing
    assert tp_param_names(model, 3, MIN_DIM) != got  # 3 divides none of the widths


def test_tp_training_matches_jax(ref, tp_run):
    _, ranks = tp_run
    assert ranks[0]["tp_names"] == ref["names"]["drivable"]
    np.testing.assert_allclose(ranks[0]["losses"][:STEPS], ref["losses"], rtol=1e-5, atol=1e-6)
    # the epoch checkpoint is written whole (gathered back from the slices)
    from automoe_tpu_torch.ckpt import load_checkpoint

    got = load_checkpoint(ref["dir"] / "tp" / "ckpt" / "bdd_drivable" / "run" / "epoch_1.pt")
    sd = got["model_state_dict"]
    for k, want in ref["want"].items():
        assert sd[k].shape == want.shape, k
        if k.endswith("num_batches_tracked"):  # JAX counts no BatchNorm steps
            continue
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # both ranks end with the same whole state
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k


def test_tp_checkpoint_resumes_on_one_process(ref, tp_run):
    spec, ranks = tp_run
    resumed = mode_run(0, 1, None, None, {
        **_spec(ref, "resumed", init=False, epochs=2, resume="full", resume_from="epoch_1"),
        "ckpt": spec["out"] + "/ckpt"})
    assert len(resumed["losses"]) == STEPS  # epoch 2 only
    np.testing.assert_allclose(resumed["losses"], ranks[0]["losses"][STEPS:], rtol=1e-5,
                               atol=1e-6)
    for k, v in ranks[0]["state"].items():
        if v.is_floating_point():
            np.testing.assert_allclose(resumed["state"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def tp_cache_runs(module_tmp):
    """`gating --cache-expert-features` with --tp-min-dim 128 on 2 ranks
    (data 1 x model 2) and in one process, from the same seed."""
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    tmp = module_tmp("tp_cache")
    root = synth_carla_sequence(tmp / "seq", n_per_split={"train": 16, "val": 12}, runs=2,
                                size=S, seed=4)
    (tmp / "cfg.json").write_text(json.dumps(GATING_CFG))

    def argv(name, *extra):
        return ["gating", "--model-config", str(tmp / "cfg.json"), "--data-root", str(root),
                "--image-size", str(S), "--batch-size", "4", "--epochs", "1",
                "--num-workers", "1", "--device", "cpu", "--cache-expert-features",
                "--learning-rate", str(LR), "--feature-cache-dir", str(tmp / name / "cache"),
                "--ckpt-root", str(tmp / name / "ck"), "--runs-root", str(tmp / name / "runs"),
                *extra]

    run_ranks("cli_logged", 2, tmp / "two_out",
              argv("two", "--tp-min-dim", str(MIN_DIM), "--model-axis", "2"))
    run_ranks("cli_logged", 1, tmp / "one_out", argv("one"))
    return tmp


def test_tp_feature_cache_equals_one_process(tp_cache_runs):
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.models import create_automoe_model
    from automoe_tpu_torch.parallel.tp import tp_param_names

    tmp = tp_cache_runs
    model = create_automoe_model(load_model_config(json.dumps(GATING_CFG)),
                                 fast_gating_pool=True, device="cpu")
    split = tp_param_names(model, 2, MIN_DIM)
    assert any(n.endswith("query_embed.weight") for n in split), split

    one = sorted((tmp / "one" / "cache").glob("pooled_*.npz"))
    two = sorted((tmp / "two" / "cache").glob("pooled_*.npz"))
    assert len(one) == 2  # train and val
    assert [p.name for p in two] == [p.name for p in one]  # the same fingerprints
    for a, b in zip(one, two):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for f in za.files:
                # a column-parallel conv sums its slice's channels in another order
                np.testing.assert_allclose(zb[f], za[f], rtol=1e-6, atol=1e-7,
                                           err_msg=f"{a.name} {f}")

    def run(name):
        losses = [r["train/loss"] for r in map(json.loads, (
            tmp / name / "runs" / "gating_run" / "metrics.jsonl").read_text().splitlines())
            if "train/loss" in r]
        return load_checkpoint(tmp / name / "ck" / "gating" / "run" / "last.pt"), losses

    (a, la), (b, lb) = run("one"), run("two")
    assert a["step"] == b["step"] == len(la) == len(lb) > 0
    np.testing.assert_allclose(lb, la, rtol=1e-5)
    sd = b["model_state_dict"]
    for k, v in a["model_state_dict"].items():
        assert sd[k].shape == v.shape, k  # written whole
        if v.is_floating_point():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=4 * LR * a["step"], err_msg=k)


def test_trainer_tp_guards():
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    wl = bdd_expert_workload("drivable")
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="tensor parallelism .* needs a mesh with a 'model' "
                                         "axis > 1"):
        Trainer(wl, [], None, TrainConfig(tp_min_dim=128),
                mesh=types.SimpleNamespace(shape={"data": 8, "model": 1}))
    with pytest.raises(ValueError, match="model"):
        Trainer(wl, [], None, TrainConfig(tp_min_dim=128), mesh=None)
    with pytest.raises(ValueError, match="exclusive"):
        Trainer(wl, [], None, TrainConfig(tp_min_dim=128, spatial=True), mesh=mesh)
    with pytest.raises(ValueError, match="pp_microbatches is exclusive with tp_min_dim"):
        Trainer(wl, [], None, TrainConfig(tp_min_dim=128, pp_microbatches=2), mesh=mesh)


@pytest.mark.parametrize("argv,match", [
    (["bdd", "--task", "drivable", "--tp-min-dim", "128", "--no-mesh"],
     "--tp-min-dim requires a device mesh"),
    (["bdd", "--task", "drivable", "--tp-min-dim", "128"], "--tp-min-dim needs --model-axis > 1"),
    (["bdd", "--task", "drivable", "--tp-min-dim", "128", "--spatial", "--model-axis", "2"],
     r"--spatial and --tp-min-dim are exclusive \(both consume the 'model' mesh axis\)"),
    (["gating", "--parallelism", "ep", "--tp-min-dim", "128"],
     "--tp-min-dim is exclusive with --parallelism ep"),
], ids=["no-mesh", "model-axis", "spatial", "ep"])
def test_train_cli_tp_guards(argv, match, tmp_path):
    import re

    from automoe_tpu_torch.train.cli import main

    with pytest.raises(SystemExit) as e:
        main(argv + ["--data-root", str(tmp_path), "--device", "cpu"])
    assert re.search(match, str(e.value.code)), e.value.code


def test_launcher_forwards_tp_and_spatial():
    from automoe_tpu_torch.tools import launch

    args = types.SimpleNamespace(
        epochs=1, batch_size=2, data_root=None, run_name="r", ckpt_root="c", runs_root="u",
        device="cpu", no_mesh=False, model_axis=2, multihost=False, spatial=True,
        tp_min_dim=256, coordinator=None, num_processes=None, process_id=None,
        image_size=None, num_workers=None, horizon=None, model_config=None)
    argv = launch._stage_args(["bdd", "--task", "drivable"], args)
    assert "--spatial" in argv and argv[argv.index("--tp-min-dim") + 1] == "256"
    assert json.dumps(argv)  # plain strings only
