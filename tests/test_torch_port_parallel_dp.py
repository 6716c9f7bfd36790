"""The port's process groups and data parallelism (automoe_tpu_torch/
parallel/mesh.py, parallel/batchnorm.py, the sharded sampler and the
Trainer under a mesh) on the CPU, each rank a gloo subprocess
(tests/torch_port_ranks.py, every rank joined with its own 120 s timeout):

* the sampler's shards against the JAX package's ShardedSampler (the one
  module fixture), index for index, drop_last and wrap-padding included;
* the mesh's checks and backend choice in one process, with JAX's words;
* the collectives over 2 ranks, forward and backward, exactly;
* cross-rank BatchNorm1d/2d over 2 ranks against torch's BatchNorm on the
  global batch: outputs and input gradients rtol 1e-5 / atol 1e-6, affine
  gradients (summed over the ranks) and running statistics likewise;
* transitively (the one-process steps are held against JAX in the other
  test files): 2-rank `finetune-carla --task detection` steps (SGD, exact
  matcher, a seed whose matches survive rounding) against one process at
  the same global batch, losses rtol 1e-5 and parameters atol 2e-5; the
  same with grad_accum 2, and with steps_per_call 2, each with an EMA; the
  CLI (AdamW) on two ranks; a segmentation step, its BatchNorm
  statistics included; a checkpoint written by 2 ranks resumed by one
  process, which ends where an unbroken one-process run ends.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
from tests.torch_port_ranks import build_trainer, run_ranks, trainer_result

SAMPLER_CASES = [(10, 3, True, 2), (10, 3, False, 2), (7, 4, False, 3), (3, 4, False, 2),
                 (16, 2, True, 4), (5, 1, False, 2)]


@pytest.fixture(scope="module")
def ref():
    """The JAX sampler's streams for every SAMPLER_CASES case, shards and
    epochs 0 and 1."""
    from automoe_tpu.data.loader import ShardedSampler

    out = {}
    for n, shards, drop_last, bs in SAMPLER_CASES:
        for epoch in (0, 1):
            for i in range(shards):
                s = ShardedSampler(n, shuffle=True, seed=5, num_shards=shards, shard_index=i,
                                   drop_last=drop_last, batch_size=bs)
                s.set_epoch(epoch)
                out[(n, shards, drop_last, bs, epoch, i)] = ([(list(b), r) for b, r in s],
                                                             len(s))
    return out


@pytest.mark.parametrize("case", SAMPLER_CASES, ids=lambda c: "n{}-shards{}-{}-b{}".format(
    c[0], c[1], "drop" if c[2] else "pad", c[3]))
def test_sampler_shards_match_jax(ref, case):
    from automoe_tpu_torch.data.loader import ShardedSampler

    n, shards, drop_last, bs = case
    for epoch in (0, 1):
        for i in range(shards):
            s = ShardedSampler(n, shuffle=True, seed=5, num_shards=shards, shard_index=i,
                               drop_last=drop_last, batch_size=bs)
            s.set_epoch(epoch)
            assert ([(list(b), r) for b, r in s], len(s)) == ref[(n, shards, drop_last, bs,
                                                                  epoch, i)]


def test_mesh_checks_and_backend_choice():
    from automoe_tpu_torch.parallel import MeshSpec, choose_backend, make_mesh
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    with pytest.raises(ValueError, match=r"mesh 1x2 != 1 devices"):
        make_mesh(MeshSpec(model=2), device="cpu")
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        make_mesh(MeshSpec(data=2), device="cpu")
    mesh = make_mesh(MeshSpec(), device="cpu")  # a group of one: no collective
    assert mesh.shape == {"data": 1, "model": 1} and mesh.backend is None
    x = torch.ones(3, requires_grad=True)
    assert mesh.sum(x) is x and mesh.permute(x) is x and mesh.gather(x).shape == (1, 3)
    assert int(mesh.loss_denominator(torch.tensor(0))) == 1
    clear_mesh()
    assert choose_backend("cpu", 2) == "gloo"
    assert choose_backend("cuda", 1, cuda_count=1) == "nccl"
    assert choose_backend("cuda", 4, cuda_count=1) == "gloo"  # ranks sharing one card
    assert choose_backend("cuda", 4, cuda_count=4) == "nccl"


def test_collectives_over_two_ranks(tmp_path):
    res = run_ranks("collectives", 2, tmp_path)
    x = [torch.arange(3.0) * (r + 1) for r in range(2)]
    w = [1.0, 2.0]
    for r in range(2):
        assert res[r]["backend"] == "gloo" and not res[r]["staging"]
        y, g = res[r]["sum"]
        assert torch.equal(y, x[0] + x[1]) and torch.equal(g, torch.full((3,), sum(w)))
        y, g = res[r]["mean"]
        assert torch.equal(y, (x[0] + x[1]) / 2) and torch.equal(g, torch.full((3,), 1.5 / 1))
        y, g = res[r]["gather"]
        assert torch.equal(y, torch.stack(x)) and torch.equal(g, torch.full((3,), sum(w)))
        y, g = res[r]["permute"]  # rank r receives rank r-1's x; its grad goes back
        assert torch.equal(y, x[1 - r]) and torch.equal(g, torch.full((3,), w[1 - r]))
        # counts 1 and 2 on the two model ranks (replicas of one data row)
        assert float(res[r]["denominator"]) == 1.5


def test_cross_rank_batchnorm_equals_global_batch(tmp_path):
    from torch import nn

    res = run_ranks("batchnorm", 2, tmp_path, 11)
    for kind, shape in (("2d", (8, 3, 5, 4)), ("1d", (8, 3)), ("1d_seq", (8, 3, 6))):
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.normal(2.0, 3.0, size=shape).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        bn = (nn.BatchNorm2d if kind == "2d" else nn.BatchNorm1d)(3)
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
            bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
        xg = x.clone().requires_grad_(True)
        y = bn(xg)
        (y * g).sum().backward()
        got = [r[kind] for r in res]
        kw = dict(rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(torch.cat([r["y"] for r in got]), y.detach(), **kw)
        torch.testing.assert_close(torch.cat([r["dx"] for r in got]), xg.grad, **kw)
        torch.testing.assert_close(got[0]["dw"] + got[1]["dw"], bn.weight.grad, **kw)
        torch.testing.assert_close(got[0]["db"] + got[1]["db"], bn.bias.grad, **kw)
        for r in got:
            torch.testing.assert_close(r["running_mean"], bn.running_mean, **kw)
            torch.testing.assert_close(r["running_var"], bn.running_var, **kw)
            assert int(r["count"]) == int(bn.num_batches_tracked) == 1


@pytest.fixture(scope="module")
def caches(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_carla_detection, synth_carla_segmentation

    root = module_tmp("parallel_caches")
    return {
        "detection": synth_carla_detection(root / "det", n_per_split={"train": 8, "val": 4},
                                           size=64, max_boxes=3, seed=4),
        "segmentation": synth_carla_segmentation(root / "seg", size=32, seed=4,
                                                 n_per_split={"train": 8, "val": 4}),
    }


def _spec(caches, out, task="detection", **config):
    spec = {"root": str(caches[task]), "global_batch": 4, "seed": 3, "out": str(out),
            "config": {"epochs": 2, "learning_rate": 0.01, "optimizer": "sgd", **config}}
    if task == "detection":
        spec.update(factory="get_carla_detection_loader", loader={"box_cap": 3},
                    workload="bdd_expert_workload",
                    workload_kw={"task": "detection", "matcher": "hungarian",
                                 "bbox_loss_weight": 1.0})
    else:
        spec.update(factory="get_carla_segmentation_loader", workload="bdd_expert_workload",
                    workload_kw={"task": task})
    return spec


def _one_process(spec):
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    torch.manual_seed(0)
    trainer = build_trainer(spec, None, 1)
    trainer.fit()
    clear_mesh()
    return trainer_result(trainer, spec)


def _assert_same_run(two, one, atol=2e-5):
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(two["val"], one["val"], rtol=1e-5)
    for k, v in one["state"].items():
        if v.is_floating_point():
            torch.testing.assert_close(two["state"][k], v, rtol=1e-4, atol=atol, msg=k)
        else:
            assert torch.equal(two["state"][k], v), k


def test_two_rank_detection_equals_one_rank(caches, tmp_path):
    """Two data ranks of 2 rows each against one process of 4: the same
    global batches, so the same losses, parameters and BatchNorm
    statistics (the ranks' batches are global-batch BatchNorm'd)."""
    two = run_ranks("train", 2, tmp_path / "ranks", _spec(caches, tmp_path / "two"))[0]
    one = _one_process(_spec(caches, tmp_path / "one"))
    assert len(one["losses"]) == 4
    _assert_same_run(two, one)


@pytest.mark.parametrize("mode", [{"grad_accum": 2}, {"steps_per_call": 2}],
                         ids=["grad-accum", "steps-per-call"])
def test_two_rank_grad_accum_and_ema_equal_one_rank(caches, tmp_path, mode):
    kw = dict(ema_decay=0.999, epochs=1, **mode)
    two = run_ranks("train", 2, tmp_path / "ranks", _spec(caches, tmp_path / "two", **kw))[0]
    one = _one_process(_spec(caches, tmp_path / "one", **kw))
    _assert_same_run(two, one)
    for k, v in one["ema"].items():
        torch.testing.assert_close(two["ema"][k], v, rtol=1e-4, atol=2e-5, msg=k)


def test_two_rank_segmentation_batchnorm_equals_one_rank(caches, tmp_path):
    """A segmentation run (CE over the pixels not ignored, so a data-group
    count) on two ranks: its BatchNorm statistics are the global batch's."""
    kw = dict(epochs=1)
    two = run_ranks("train", 2, tmp_path / "ranks",
                    _spec(caches, tmp_path / "two", "segmentation", **kw))[0]
    one = _one_process(_spec(caches, tmp_path / "one", "segmentation", **kw))
    _assert_same_run(two, one)
    assert any("running_var" in k for k in one["state"])


def test_distributed_checkpoint_resumes_on_one_process(caches, tmp_path):
    """Epoch 1 on two ranks, epoch 2 resumed (--resume full) by one
    process from their checkpoint, against two epochs in one process."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.parallel.mesh import clear_mesh

    out = tmp_path / "split"  # a constant schedule: one that counts epochs would differ
    run_ranks("train", 2, tmp_path / "ranks", _spec(caches, out, epochs=1,
                                                      schedule="constant"))
    last = load_checkpoint(out / "ckpt" / "bdd_detection" / "run" / "last.pt")
    single = build_trainer(_spec(caches, tmp_path / "x", epochs=1), None, 1)
    assert set(last["model_state_dict"]) == set(single.model.state_dict())
    assert last["epoch"] == 0 and last["step"] == 2
    spec = _spec(caches, out, resume="full", schedule="constant")
    resumed = build_trainer(spec, None, 1)
    assert resumed.resumed and resumed.start_epoch == 1
    resumed.fit()
    clear_mesh()
    got = trainer_result(resumed, spec)
    want = _one_process(_spec(caches, tmp_path / "one", schedule="constant"))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, v in want["state"].items():
        if v.is_floating_point():
            torch.testing.assert_close(got["state"][k], v, rtol=1e-4, atol=2e-5, msg=k)


def test_two_rank_cli_equals_one_rank(caches, tmp_path):
    """`automoe-train-torch finetune-carla --task detection` as two ranks
    (--multihost, 2 rows each) against one process of 4 rows: epoch losses
    rtol 1e-4; parameters rtol 1e-3 / atol 4·lr·steps, since AdamW moves a
    parameter whose gradient is rounding noise by up to ~lr a step
    whatever the noise's size (chip_smoke.py phase 21 holds its runs to the
    same rule)."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.train.cli import main

    def argv(out, batch):
        return ["finetune-carla", "--task", "detection", "--data-root",
                str(caches["detection"]), "--image-size", "64", "--box-cap", "3", "--epochs",
                "2", "--num-workers", "1", "--device", "cpu", "--seed", "3", "--matcher",
                "hungarian", "--batch-size", str(batch), "--ckpt-root", str(out / "ckpt"),
                "--runs-root", str(out / "runs")]

    torch.manual_seed(0)
    main(argv(tmp_path / "one", 4))
    run_ranks("cli", 2, tmp_path / "ranks", argv(tmp_path / "two", 2))
    one, two = (load_checkpoint(tmp_path / d / "ckpt" / "bdd_detection" / "run" / "last.pt")
                for d in ("one", "two"))
    assert one["step"] == two["step"] == 4
    lr = 2e-4  # finetune-carla's default
    np.testing.assert_allclose(two["best_val_loss"], one["best_val_loss"], rtol=1e-4)
    for k, v in one["model_state_dict"].items():
        if v.is_floating_point():
            torch.testing.assert_close(two["model_state_dict"][k], v, rtol=1e-3,
                                       atol=4 * lr * one["step"], msg=k)
    epochs = [[r["train/loss_epoch"] for r in map(json.loads, (
        tmp_path / d / "runs" / "bdd_detection_run" / "metrics.jsonl").read_text().splitlines())
        if "train/loss_epoch" in r] for d in ("one", "two")]
    assert len(epochs[0]) == 2
    np.testing.assert_allclose(epochs[1], epochs[0], rtol=1e-4)
