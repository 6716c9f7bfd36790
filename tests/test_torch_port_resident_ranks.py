"""The device-resident loader's index mode and its multi-rank staging, and
the feature cache over several ranks (automoe_tpu_torch/data/
device_resident.py, train/feature_cache.py, train/step.py::
make_indexed_scan_train_step), on the CPU; ranks are gloo subprocesses
(tests/torch_port_ranks.py) and the JAX references come from the one
module fixture:

* index mode: for the same arrays and seed, the loader yields JAX's base
  indices and its flat [S, B, ...] epoch, epoch by epoch, exactly;
* the Trainer's indexed K-step call equals the grouped one bit for bit,
  and JAX's indexed Trainer run from the same weights (drivable, 32 px,
  B 4, K 2, SGD) within rtol 1e-4 / atol 1e-6 (the parameters) and rtol
  1e-5 (the losses);
* two data ranks each staging their shard (`indices=range(d, N, 2)`)
  yield exactly their rows of the global batches of one process staging
  the same flat epoch, epoch by epoch, in both modes;
* `gating --cache-expert-features --device-resident --steps-per-call 2
  --feature-cache-dir D` on two ranks equals one process over the same
  global batches (losses rtol 1e-5; parameters, AdamW, with
  tests/test_torch_port_parallel_dp.py's CLI rule rtol 1e-3 / atol
  4·lr·steps; dropout off in both, since the port draws a data rank's
  masks from its data index: ROADMAP.md §3),
  and the pass shared over the ranks writes one-process caches: the same
  fingerprints (file names) and the same array bytes.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
from tests.torch_port_ranks import run_ranks

B, K, N, S, LR = 4, 2, 16, 32, 1e-3

GATING_CFG = {
    "experts": [{"type": "drivable", "num_classes": 3},
                {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
                 "use_lidar": False}],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}


def _seg_arrays(n, size=S, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "mask": rng.integers(0, 3, (n, size, size)).astype(np.int32)}


@pytest.fixture(scope="module")
def ref(module_tmp):
    """JAX's index-mode streams, and its indexed Trainer run (SGD) with the
    weights it started from."""
    from automoe_tpu.data.device_resident import DeviceEpochLoader
    from automoe_tpu.train.loop import TrainConfig, Trainer
    from automoe_tpu.train.workloads import bdd_expert_workload

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax

    out = {"dir": module_tmp("resident_ref")}
    arr = _seg_arrays(N)
    loader = DeviceEpochLoader(arr, batch_size=B, group_size=K, seed=3, index_mode=True)
    out["streams"] = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        out["streams"].append(([int(g["__group_index__"]) for g in loader],
                               {k: np.asarray(v) for k, v in loader.epoch_batches.items()}))
    tmp = out["dir"]
    cfg = TrainConfig(epochs=1, learning_rate=1e-3, weight_decay=0.0, optimizer="sgd",
                      run_name="j", ckpt_root=str(tmp / "ckpt"), runs_root=str(tmp / "runs"),
                      log_every=1, max_inflight=0, steps_per_call=K)
    val = [{k: v[:B] for k, v in arr.items()}]
    jtr = Trainer(bdd_expert_workload("drivable", image_size=S),
                  DeviceEpochLoader(arr, batch_size=B, group_size=K, seed=3, index_mode=True),
                  val, cfg)
    init = jax.device_get({"params": jtr.state.params, "batch_stats": jtr.state.batch_stats})
    jtr.fit()
    out["init"] = expert_state_dict_from_jax(init, "drivable")
    out["want"] = expert_state_dict_from_jax(jax.device_get(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}), "drivable")
    out["losses"] = [r["train/loss"] for r in map(json.loads, (
        tmp / "runs" / "bdd_drivable_j" / "metrics.jsonl").read_text().splitlines())
        if "train/loss" in r]
    return out


def _port_loader(arrays, **kw):
    from automoe_tpu_torch.data.device_resident import DeviceEpochLoader

    return DeviceEpochLoader(arrays, device="cpu", **kw)


def test_index_mode_streams_match_jax(ref):
    loader = _port_loader(_seg_arrays(N), batch_size=B, group_size=K, seed=3, index_mode=True)
    assert len(loader) == N // B
    for epoch, (want_idx, want_flat) in enumerate(ref["streams"]):
        loader.set_epoch(epoch)
        assert [int(g["__group_index__"]) for g in loader] == want_idx
        for k, v in want_flat.items():
            np.testing.assert_array_equal(loader.epoch_batches[k].numpy(), v, err_msg=k)
    with pytest.raises(ValueError, match="index_mode yields base indices"):
        _port_loader(_seg_arrays(N), batch_size=B, group_size=K, index_mode=True,
                     shared={"x": np.zeros((B, 1), np.float32)})


def _trainer(tmp, loader, arr, init):
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    cfg = TrainConfig(epochs=1, learning_rate=1e-3, weight_decay=0.0, optimizer="sgd",
                      run_name="p", ckpt_root=str(tmp / "ckpt"), runs_root=str(tmp / "runs"),
                      log_every=1, max_inflight=0, steps_per_call=K, device="cpu")
    tr = Trainer(bdd_expert_workload("drivable"), loader, [{k: v[:B] for k, v in arr.items()}],
                 cfg)
    tr.model.load_state_dict(init, strict=True)
    tr.fit()
    losses = [r["train/loss"] for r in map(json.loads, (
        tmp / "runs" / "bdd_drivable_p" / "metrics.jsonl").read_text().splitlines())
        if "train/loss" in r]
    return tr.model.state_dict(), losses


def test_indexed_call_matches_grouped_and_jax(ref, tmp_path):
    arr = _seg_arrays(N)
    indexed, li = _trainer(tmp_path / "i", _port_loader(arr, batch_size=B, group_size=K, seed=3,
                                                        index_mode=True), arr, ref["init"])
    grouped, lg = _trainer(tmp_path / "g", _port_loader(arr, batch_size=B, group_size=K,
                                                        seed=3), arr, ref["init"])
    assert li == lg and len(li) == N // (B * K)  # a logged loss a K-step call
    for k, v in grouped.items():
        assert torch.equal(indexed[k], v), k
    np.testing.assert_allclose(li, ref["losses"], rtol=1e-5)
    for k, want in ref["want"].items():
        if k.endswith("num_batches_tracked"):  # JAX counts no BatchNorm steps
            continue
        np.testing.assert_allclose(indexed[k].numpy(), want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.fixture(scope="module")
def gating_runs(module_tmp):
    """`gating --cache-expert-features --device-resident` on 2 ranks, and in
    one process over the same flat epoch (the ranks' shards in rank order)."""
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    tmp = module_tmp("gating_ranks")
    root = synth_carla_sequence(tmp / "seq", n_per_split={"train": 30, "val": 14}, runs=2,
                                size=S, seed=4)
    (tmp / "cfg.json").write_text(json.dumps(GATING_CFG))

    def argv(name, batch):
        return ["gating", "--model-config", str(tmp / "cfg.json"), "--data-root", str(root),
                "--image-size", str(S), "--batch-size", str(batch), "--epochs", "2",
                "--num-workers", "1", "--device", "cpu", "--cache-expert-features",
                "--device-resident", "--steps-per-call", str(K), "--learning-rate", str(LR),
                "--feature-cache-dir", str(tmp / name / "cache"),
                "--ckpt-root", str(tmp / name / "ck"), "--runs-root", str(tmp / name / "runs")]

    # one process (a subprocess, as the ranks, for the same threads and
    # hence the same bits) over the flat epoch the two ranks assemble
    ranks = run_ranks("cli_logged", 2, tmp / "ranks_out", argv("two", 2))
    run_ranks("cli_flat_of", 1, tmp / "one_out", argv("one", 4), 2)
    return tmp, ranks


def _run(tmp: Path, name: str):
    from automoe_tpu_torch.ckpt import load_checkpoint

    losses = [r["train/loss"] for r in map(json.loads, (
        tmp / name / "runs" / "gating_run" / "metrics.jsonl").read_text().splitlines())
        if "train/loss" in r]
    return load_checkpoint(tmp / name / "ck" / "gating" / "run" / "last.pt"), losses


def test_two_rank_residency_equals_one_process(gating_runs):
    tmp, _ = gating_runs
    (one, l1), (two, l2) = _run(tmp, "one"), _run(tmp, "two")
    assert one["step"] == two["step"] == K * len(l1) == K * len(l2) > 0  # a loss a call
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for k, v in one["model_state_dict"].items():
        if v.is_floating_point():  # AdamW: tests/test_torch_port_parallel_dp.py's CLI rule
            np.testing.assert_allclose(two["model_state_dict"][k].numpy(), v.numpy(),
                                       rtol=1e-3, atol=4 * LR * one["step"], err_msg=k)


def test_two_rank_feature_cache_equals_one_process(gating_runs):
    tmp, _ = gating_runs
    one = sorted((tmp / "one" / "cache").glob("pooled_*.npz"))
    two = sorted((tmp / "two" / "cache").glob("pooled_*.npz"))
    assert len(one) == 2  # train and val
    assert [p.name for p in two] == [p.name for p in one]  # the same fingerprints
    for a, b in zip(one, two):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for f in za.files:
                assert za[f].tobytes() == zb[f].tobytes(), (a.name, f)


def test_two_rank_loader_rows(tmp_path):
    """Rank d of 2, staging range(d, N, 2), yields rows [2d, 2d + 2) of each
    global batch of one process staging the same flat epoch (grouped and
    indexed, two epochs)."""
    res = run_ranks("resident_rows", 2, tmp_path, N, 2, K)
    for index_mode in (False, True):
        one = res[0][f"one_{index_mode}"]
        for d in range(2):
            got = res[d][f"rank_{index_mode}"]
            assert len(got) == len(one)
            for a, b in zip(got, one):
                np.testing.assert_array_equal(a, b[..., 2 * d:2 * d + 2], err_msg=str(d))
