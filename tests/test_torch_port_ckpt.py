"""The port's checkpoints and resume on the CPU (automoe_tpu_torch/ckpt,
train/loop.py): a run interrupted after epoch 1, or inside epoch 2, and
resumed with resume='full' ends bit-identical (torch.equal) to the
uninterrupted run, parameters, BatchNorm statistics and optimizer state
included; `step` falls back to `last`, and to a fresh start when nothing
was saved; epoch_N retention; the missing-key guard; --init-from seeds
fresh state only. Workloads: the policy (constant schedule), the gating
network over a small AutoMoE (per-epoch cosine, live dropout) and the
detection expert (cosine, auction matcher)."""
from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

import tests.torch_port_common  # noqa: F401  (caps torch's threads)

S, HORIZON, B = 32, 4, 2
MODEL_CFG = {
    "experts": [
        {"type": "detection", "num_classes": 10},
        {"type": "segmentation", "num_classes": 19},
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": HORIZON},
}


class _Crash(Exception):
    pass


class CrashingLoader:
    """A loader that raises at batch `after` of epoch `epoch` (a run killed
    mid-training)."""

    def __init__(self, loader, epoch: int, after: int):
        self.loader, self.crash_epoch, self.after = loader, epoch, after
        self.epoch = 0
        self.dataset = loader.dataset

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        self.epoch = epoch
        self.loader.set_epoch(epoch, skip_batches)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if self.epoch == self.crash_epoch and i == self.after:
                raise _Crash
            yield b


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    from automoe_tpu_torch.tools.synth import synth_carla_detection, synth_carla_sequence

    root = tmp_path_factory.mktemp("caches")
    return {
        "seq": synth_carla_sequence(root / "seq", n_per_split={"train": 18, "val": 12},
                                    size=S, seed=1),
        "det": synth_carla_detection(root / "det", n_per_split={"train": 8, "val": 3},
                                     size=S, max_boxes=3, seed=2),
    }


def _setup(kind, caches):
    """(workload, loader factory, TrainConfig overrides) of one workload."""
    from automoe_tpu_torch.data import get_carla_detection_loader, get_carla_sequence_loader
    from automoe_tpu_torch.train import workloads as W

    if kind == "policy":
        return (W.policy_workload(horizon=HORIZON, context_dim=8),
                lambda split, **kw: get_carla_sequence_loader(
                    split, root_dir=str(caches["seq"]), horizon=HORIZON, **kw),
                dict(schedule="constant"))
    if kind == "gating":
        return (W.gating_workload(MODEL_CFG),
                lambda split, **kw: get_carla_sequence_loader(
                    split, root_dir=str(caches["seq"]), horizon=HORIZON, **kw),
                dict(schedule="cosine_per_epoch"))
    return (W.bdd_expert_workload("detection", matcher="auction"),
            lambda split, **kw: get_carla_detection_loader(
                split, root_dir=str(caches["det"]), box_cap=4, **kw),
            dict(schedule="cosine"))


def _trainer(kind, caches, tmp, run, *, crash=None, **cfg_kw):
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer

    wl, factory, over = _setup(kind, caches)
    train = factory("train", batch_size=B, num_workers=1, seed=3)
    val = factory("val", batch_size=B, num_workers=1, shuffle=False)
    if crash is not None:
        train = CrashingLoader(train, *crash)
    kw = dict(epochs=2, learning_rate=1e-3, weight_decay=1e-4, seed=5, run_name=run,
              ckpt_root=str(tmp / "ckpt"), runs_root=str(tmp / "runs"), device="cpu", **over)
    return Trainer(wl, train, val, TrainConfig(**{**kw, **cfg_kw}))


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["count"] == ob["count"] > 0
    assert oa["state"].keys() == ob["state"].keys()
    for k in oa["state"]:
        assert all(torch.equal(x, y) for x, y in zip(oa["state"][k], ob["state"][k])), k


@pytest.fixture(scope="module")
def uninterrupted(caches, tmp_path_factory):
    """Each workload's 2-epoch run, trained once per module."""
    out = {}

    def get(kind):
        if kind not in out:
            tr = _trainer(kind, caches, tmp_path_factory.mktemp(kind), "whole")
            out[kind] = (tr, tr.fit())
        return out[kind]

    return get


@pytest.mark.parametrize("kind", ["policy", "gating", "detection"])
def test_epoch_resume_equals_uninterrupted(kind, caches, uninterrupted, tmp_path):
    """Killed in epoch 2, resumed full from `last`: the same end state as
    the uninterrupted 2-epoch run, and the same best val loss."""
    whole, whole_res = uninterrupted(kind)
    first = _trainer(kind, caches, tmp_path, "r", crash=(1, 0))
    with pytest.raises(_Crash):
        first.fit()
    resumed = _trainer(kind, caches, tmp_path, "r", resume="full", resume_from="last")
    assert resumed.resumed and resumed.start_epoch == 1 and resumed.start_batch == 0
    assert resumed.optimizer.count == len(first.train_loader)
    res = resumed.fit()
    _assert_same_state(whole, resumed)
    assert res["best_val_loss"] == whole_res["best_val_loss"]


@pytest.mark.parametrize("kind", ["policy", "gating"])
def test_step_resume_equals_uninterrupted(kind, caches, uninterrupted, tmp_path):
    """Killed at batch 3 of epoch 2 with a `step` checkpoint every 2 steps,
    resumed full from `step`: the loader skips the 2 consumed batches at
    the index level (they are never decoded) and the run ends as the
    uninterrupted one."""
    whole, _ = uninterrupted(kind)
    first = _trainer(kind, caches, tmp_path, "s", crash=(1, 3), save_every_steps=2)
    with pytest.raises(_Crash):
        first.fit()
    resumed = _trainer(kind, caches, tmp_path, "s", resume="full", resume_from="step",
                       save_every_steps=2)
    assert (resumed.start_epoch, resumed.start_batch) == (1, 2)
    reads = []
    ds = resumed.train_loader.dataset
    getitem = ds.__getitem__
    ds.__getitem__ = lambda i: reads.append(i) or getitem(i)
    resumed.fit()
    assert len(reads) == (len(resumed.train_loader) - 2) * B
    _assert_same_state(whole, resumed)
    assert not resumed.ckpt.path("step").exists()  # stale once its epoch completed


def test_step_falls_back_to_last_then_to_a_fresh_start(caches, tmp_path):
    fresh = _trainer("policy", caches, tmp_path, "f", resume="full", resume_from="step")
    assert not fresh.resumed and (fresh.start_epoch, fresh.start_batch) == (0, 0)
    assert fresh.optimizer.count == 0
    one = _trainer("policy", caches, tmp_path, "f", epochs=1)
    one.fit()
    assert not one.ckpt.path("step").exists() and one.ckpt.path("last").exists()
    again = _trainer("policy", caches, tmp_path, "f", resume="full", resume_from="step")
    assert again.resumed and (again.start_epoch, again.start_batch) == (1, 0)
    assert again.optimizer.count == one.optimizer.count
    assert again.ckpt.best_val == one.ckpt.best_val


def test_resume_model_mode_loads_weights_only(caches, tmp_path):
    one = _trainer("policy", caches, tmp_path, "m", epochs=1)
    one.fit()
    tr = _trainer("policy", caches, tmp_path, "m", resume="model", resume_from="best")
    assert tr.resumed and tr.start_epoch == 0 and tr.optimizer.count == 0
    for k, v in one.model.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 2)
        self.bn = torch.nn.BatchNorm1d(2)


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_keep_epochs_collects_old_periodic_checkpoints(tmp_path, async_save):
    from automoe_tpu_torch.ckpt import CheckpointManager, load_checkpoint
    from automoe_tpu_torch.train.state import make_optimizer

    model = _Tiny()
    opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, total_steps=4)
    mgr = CheckpointManager(str(tmp_path), "tiny", "run", save_freq=1, async_save=async_save,
                            keep=2)
    for epoch, val in enumerate((3.0, 2.0, 2.5, 2.2)):
        with torch.no_grad():
            model.fc.weight.add_(1.0)  # the snapshot must not see later updates
        mgr.save_step(model, opt, epoch, batch_index=1)
        mgr.save_epoch(model, opt, epoch, val, config={"epoch": epoch})
    mgr.wait()
    names = sorted(p.name for p in mgr.dir.iterdir())
    assert names == ["best.pt", "config.json", "epoch_3.pt", "epoch_4.pt", "last.pt"]
    best, last = load_checkpoint(mgr.path("best")), load_checkpoint(mgr.path("last"))
    assert (best["epoch"], best["best_val_loss"]) == (1, 2.0)
    assert last["epoch"] == 3 and last["best_val_loss"] == 2.0
    assert torch.equal(last["model_state_dict"]["fc.weight"], model.fc.weight.detach())
    assert torch.equal(best["model_state_dict"]["fc.weight"] + 2, model.fc.weight.detach())


def test_missing_key_raises(tmp_path):
    from automoe_tpu_torch.ckpt import CheckpointManager, load_variables
    from automoe_tpu_torch.train.state import make_optimizer

    model = _Tiny()
    opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, total_steps=1)
    mgr = CheckpointManager(str(tmp_path), "tiny", "run")
    mgr.save_epoch(model, opt, 0, 1.0)
    bigger = _Tiny()
    bigger.extra = torch.nn.Linear(2, 2)
    with pytest.raises(KeyError, match="extra.weight"):
        load_variables(mgr.path("best"), bigger)
    opt2 = make_optimizer(bigger.named_parameters(), learning_rate=1e-3, total_steps=1)
    with pytest.raises(KeyError, match="missing from the checkpoint"):
        mgr.restore(bigger, opt2, which="best", mode="model")
    load_variables(mgr.path("best"), _Tiny())  # same keys: loads


def test_init_from_seeds_fresh_state_only(caches, tmp_path):
    """--init-from seeds a fresh run with the source's weights and
    BatchNorm statistics and a fresh optimizer; a run whose --resume
    restored a checkpoint keeps its own state."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.train.cli import _graft_init_from

    src = _trainer("detection", caches, tmp_path, "src", epochs=1)
    src.fit()
    src_sd = load_checkpoint(src.ckpt.path("best"))["model_state_dict"]
    args = argparse.Namespace(init_from=str(src.ckpt.path("best")))

    fresh = _graft_init_from(_trainer("detection", caches, tmp_path, "dst", epochs=1), args)
    assert fresh.optimizer.count == 0
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, src_sd[k]), k
    fresh.fit()  # dst now has a `last` of its own, with moved statistics
    dst_sd = load_checkpoint(fresh.ckpt.path("last"))["model_state_dict"]

    resumed = _graft_init_from(_trainer("detection", caches, tmp_path, "dst", epochs=2,
                                        resume="full"), args)
    assert resumed.resumed
    moved = 0
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, dst_sd[k]), k
        moved += not torch.equal(v, src_sd[k])
    assert moved > 0


def test_optimizer_state_dict_round_trip():
    from automoe_tpu_torch.train.state import make_optimizer

    model = _Tiny()
    opt = make_optimizer(model.named_parameters(), learning_rate=1e-2, total_steps=4,
                         trainable_mask={"bn.weight": False})
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
    sd = opt.state_dict()
    assert "bn.weight" not in sd["state"] and sd["count"] == 2
    other = make_optimizer(_Tiny().named_parameters(), learning_rate=1e-2, total_steps=4,
                           trainable_mask={"bn.weight": False})
    other.load_state_dict(sd)
    assert other.count == 2 and other.lr_at(other.count) == opt.lr_at(opt.count)
    for n in sd["state"]:
        assert all(torch.equal(a, b) for a, b in zip(other.state[n], opt.state[n]))
    wrong = make_optimizer(_Tiny().named_parameters(), learning_rate=1e-2, total_steps=4)
    with pytest.raises(KeyError):
        wrong.load_state_dict(sd)


def test_loader_skip_batches_matches_the_tail_of_the_epoch(caches):
    from automoe_tpu_torch.data import get_carla_sequence_loader

    kw = dict(root_dir=str(caches["seq"]), horizon=HORIZON, batch_size=3, num_workers=1)
    for split in ("train", "val"):
        full, part = get_carla_sequence_loader(split, **kw), get_carla_sequence_loader(split, **kw)
        full.set_epoch(1)
        part.set_epoch(1, skip_batches=2)
        want, got = list(full)[2:], list(part)
        assert len(got) == len(want) == len(full) - 2
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
