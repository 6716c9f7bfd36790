"""The port's segmentation and drivable-area paths against the JAX package
on the CPU, on the same numpy inputs and weights:

* the four datasets (BDD segmentation / drivable, CARLA segmentation /
  drivable) and their loaders on the same caches: exact. This covers the
  raw-root path resolve, channel 0 of a 3-channel drivable mask, raw CARLA
  IDs >= 19 becoming 255, and the drivable ID sets from the environment;
* `segmentation_loss`: rtol 1e-5, out-of-range labels and an all-ignored
  batch included; `seg_metrics`: rtol 1e-6 on the same logits (integer
  counts, then a float32 mean over at most C values);
* the segmentation and drivable experts' eval-mode forwards at 64 px:
  rtol 1e-4 / atol 1e-5 (at 32 px the trunk's last BatchNorm normalises 2
  values and JAX's E[x²]−E[x]² variance moves the outputs ~1e-3);
* a 3-step SGD trajectory of the segmentation workload: losses rtol 1e-4,
  parameters rtol 1e-3 / atol 1e-5;
* `evaluate_seg_like` on the trajectory's weights: rtol 1e-4;
* `bdd --task segmentation` and `finetune-carla --task drivable` through
  the CLI on the CPU.
The JAX train step is compiled once, by the trajectory."""
from __future__ import annotations

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms, nchw, nhwc

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
S, B, N_STEPS, LR = 64, 2, 3, 1e-2


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def caches(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_bdd_segmentation, synth_carla_segmentation

    tmp = module_tmp("seg")
    n = {"train": 5, "val": 3}
    return {
        "bdd-seg": synth_bdd_segmentation(tmp / "bs", n_per_split=n, size=32, seed=1),
        "bdd-drv": synth_bdd_segmentation(tmp / "bd", task="drivable", n_per_split=n, size=32,
                                          seed=2),
        "carla": synth_carla_segmentation(tmp / "c", n_per_split=n, size=32, seed=3),
    }


def _same_samples(mine, ref):
    assert len(mine) == len(ref) > 0
    for i in range(len(ref)):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["BDDSegmentationDataset", "BDDDrivableDataset"])
def test_bdd_datasets_match_jax(caches, name):
    from automoe_tpu.data import datasets as jd

    from automoe_tpu_torch.data import datasets as pd

    root = caches["bdd-seg" if "Segmentation" in name else "bdd-drv"] / "train"
    mine, ref = getattr(pd, name)(root), getattr(jd, name)(root)
    _same_samples(mine, ref)
    if name == "BDDDrivableDataset":  # channel 0 of the RGB mask
        assert set(np.unique(mine[0]["mask"])) <= {0, 1, 2}
    else:
        assert 255 in mine[0]["mask"]


def test_bdd_raw_root_resolve_matches_jax(tmp_path, monkeypatch):
    """A path that does not exist resolves against the raw root: as given,
    then its part after "images" under <raw_root>/images (an absolute
    part too)."""
    from PIL import Image

    from automoe_tpu.data.datasets import BDDSegmentationDataset as JaxDataset

    from automoe_tpu_torch.data.datasets import BDDSegmentationDataset

    raw = tmp_path / "raw"
    (raw / "images" / "train").mkdir(parents=True)
    (raw / "labels").mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)).save(
        raw / "images" / "train" / "a.png")
    Image.fromarray(rng.integers(0, 19, (16, 16), dtype=np.uint8)).save(raw / "labels" / "a.png")
    split = tmp_path / "cache" / "train"
    split.mkdir(parents=True)
    torch.save({"image_path": "/gone/bdd/images/train/a.png", "mask_path": "labels/a.png"},
               split / "00000.pt")
    mine = BDDSegmentationDataset(split, raw_root=str(raw))
    ref = JaxDataset(split, raw_root=str(raw))
    for p in ("/gone/bdd/images/train/a.png", "labels/a.png", "missing.png"):
        assert mine._resolve(p) == ref._resolve(p)
    assert mine._resolve("labels/a.png") == str(raw / "labels" / "a.png")
    _same_samples(mine, ref)
    monkeypatch.setenv("BDD100K_RAW_ROOT", str(raw))
    _same_samples(BDDSegmentationDataset(split), JaxDataset(split))


def test_carla_segmentation_dataset_matches_jax(caches):
    from automoe_tpu.data.datasets import CarlaSegmentationDataset as JaxDataset

    from automoe_tpu_torch.data.datasets import CarlaSegmentationDataset

    root = caches["carla"] / "train"
    mine = CarlaSegmentationDataset(root)
    _same_samples(mine, JaxDataset(root))
    raw = torch.load(mine.files[0], weights_only=False)["mask"].numpy()
    assert (raw >= 19).any()  # raw IDs past the classes became 255
    np.testing.assert_array_equal(mine[0]["mask"], np.where(raw >= 19, 255, raw))


@pytest.mark.parametrize("env", [{}, {"CARLA_DRIVABLE_IDS": "7,8", "CARLA_ALTERNATIVE_IDS": "1"},
                                 {"CARLA_DRIVABLE_IDS": "x"}],
                         ids=["default", "env", "malformed-env"])
def test_carla_drivable_dataset_matches_jax(caches, monkeypatch, env):
    from automoe_tpu.data.datasets import CarlaDrivableDataset as JaxDataset

    from automoe_tpu_torch.data.datasets import CarlaDrivableDataset

    for k in ("CARLA_DRIVABLE_IDS", "CARLA_ALTERNATIVE_IDS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    root = caches["carla"] / "train"
    mine = CarlaDrivableDataset(root)
    assert (mine.drivable_ids, mine.alternative_ids) == (
        ([7, 8], [1]) if "CARLA_ALTERNATIVE_IDS" in env else ([7], []))
    _same_samples(mine, JaxDataset(root))


@pytest.mark.parametrize("factory,cache", [
    ("get_bdd_segmentation_loader", "bdd-seg"), ("get_bdd_drivable_loader", "bdd-drv"),
    ("get_carla_segmentation_loader", "carla"), ("get_carla_drivable_loader", "carla")])
def test_loaders_match_jax(caches, factory, cache):
    from automoe_tpu.data import factories as jf

    from automoe_tpu_torch.data import factories as pf

    for split in ("train", "val"):
        kw = dict(split=split, batch_size=2, num_workers=2, root_dir=str(caches[cache]))
        mine, ref = getattr(pf, factory)(**kw), getattr(jf, factory)(**kw)
        assert len(mine) == len(ref)
        mine.set_epoch(1)
        ref.set_epoch(1)
        got, want = list(mine), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------------------
# loss and metrics
# ---------------------------------------------------------------------------

def _logits_masks(seed, C, *, ignored=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, 8, 8, C)).astype(np.float32) * 2
    masks = rng.integers(0, C, (B, 8, 8)).astype(np.int32)
    masks[0, :2] = 255
    masks[1, 3, :3] = [C, C + 4, -3]  # out of range: ignored by the loss
    if ignored:
        masks[:] = 255
    return logits, masks


@pytest.mark.parametrize("C,ignored", [(19, False), (3, False), (19, True)],
                         ids=["seg", "drivable", "all-ignored"])
def test_segmentation_loss_matches_jax(C, ignored):
    from automoe_tpu.losses import segmentation_loss as jax_loss

    from automoe_tpu_torch.losses import segmentation_loss

    logits, masks = _logits_masks(C, C, ignored=ignored)
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(masks))["loss"])
    got = float(segmentation_loss(nchw(logits), torch.from_numpy(masks))["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if ignored:
        assert got == 0.0


@pytest.mark.parametrize("C,ignored", [(19, False), (3, False), (19, True)],
                         ids=["seg", "drivable", "all-ignored"])
def test_seg_metrics_match_jax(C, ignored):
    from automoe_tpu.evals.segmentation import seg_metrics as jax_metrics

    from automoe_tpu_torch.evals.segmentation import seg_metrics

    logits, masks = _logits_masks(C + 1, C, ignored=ignored)
    masks[1, 5] = logits[1, 5].argmax(-1)  # some correct pixels
    want = jax_metrics(jnp.asarray(logits), jnp.asarray(masks), num_classes=C)
    got = seg_metrics(nchw(logits), torch.from_numpy(masks), num_classes=C)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    assert 0.0 <= float(got["pixel_acc"]) <= 1.0 and 0.0 <= float(got["mean_iou"]) <= 1.0


# ---------------------------------------------------------------------------
# the experts and the trajectory
# ---------------------------------------------------------------------------

def _jax_variables(task, seed):
    from automoe_tpu.train.workloads import bdd_expert_workload

    wl = bdd_expert_workload(task, image_size=S)
    v = jax.device_get(wl.init_variables(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 10)
    return wl, {"params": _perturb_norms(v["params"], rng),
                "batch_stats": _perturb_norms(v["batch_stats"], rng)}


@pytest.mark.parametrize("task", ["segmentation", "drivable"])
def test_expert_forward_matches_jax(task):
    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    wl, variables = _jax_variables(task, 3)
    x = np.random.default_rng(4).normal(size=(B, S, S, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: wl.model.apply(v, x))(variables, x))
    model = bdd_expert_workload(task).init_model(0, "cpu").eval()
    model.load_state_dict(expert_state_dict_from_jax(variables, task), strict=True)
    with torch.no_grad():
        got = nhwc(model(nchw(x)))
    assert got.shape == (B, S, S, {"segmentation": 19, "drivable": 3}[task])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _seg_batches(seed=7, n=N_STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = rng.integers(0, 19, (B, S, S)).astype(np.int32)
        mask[:, :4] = 255
        mask[1, 10, :2] = [23, 40]  # raw IDs past the classes
        out.append({"image": rng.normal(size=(B, S, S, 3)).astype(np.float32), "mask": mask})
    return out


def _losses(jsonl) -> list:
    recs = map(json.loads, jsonl.read_text().splitlines())
    return [r["train/loss"] for r in recs if "train/loss" in r]


@pytest.fixture(scope="module")
def trajectories(module_tmp):
    """N_STEPS SGD steps of the segmentation workload in both packages
    from the same weights."""
    from automoe_tpu.train.loop import TrainConfig as JaxConfig
    from automoe_tpu.train.loop import Trainer as JaxTrainer
    from automoe_tpu.train.state import TrainState

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    tmp = module_tmp("traj")
    batches = _seg_batches()
    wl, init = _jax_variables("segmentation", 5)
    kw = dict(epochs=1, learning_rate=LR, weight_decay=0.0, optimizer="sgd",
              ckpt_root=str(tmp / "ckpt"), runs_root=str(tmp / "runs"))
    jtr = JaxTrainer(wl, batches, batches, JaxConfig(run_name="j", log_every=1, max_inflight=0,
                                                     **kw))
    jtr.state = TrainState.create(params=init["params"], tx=jtr.state.tx,
                                  batch_stats=init["batch_stats"])
    jtr.train_epoch(0)
    jtr.logger.close()
    final = {"params": jax.device_get(jtr.state.params),
             "batch_stats": jax.device_get(jtr.state.batch_stats)}
    ptr = Trainer(bdd_expert_workload("segmentation"), batches, batches,
                  TrainConfig(run_name="p", device="cpu", log_every=1, **kw))
    ptr.model.load_state_dict(expert_state_dict_from_jax(init, "segmentation"), strict=True)
    ptr.train_epoch(0)
    ptr.logger.close()
    return {
        "jax_losses": _losses(tmp / "runs" / "bdd_segmentation_j" / "metrics.jsonl"),
        "port_losses": _losses(tmp / "runs" / "bdd_segmentation_p" / "metrics.jsonl"),
        "jax_final": final,
        "want": expert_state_dict_from_jax(final, "segmentation"),
        "port": ptr.model,
    }


def test_sgd_trajectory_losses_match_jax(trajectories):
    assert len(trajectories["port_losses"]) == len(trajectories["jax_losses"]) == N_STEPS
    np.testing.assert_allclose(trajectories["port_losses"], trajectories["jax_losses"],
                               rtol=1e-4)


@pytest.mark.parametrize("group", ["backbone.0", "backbone.1", "backbone.4", "backbone.5",
                                   "backbone.6", "backbone.7", "decoder."])
def test_sgd_trajectory_params_match_jax(trajectories, group):
    port = {k: v.detach() for k, v in trajectories["port"].state_dict().items()
            if not k.endswith("num_batches_tracked")}
    keys = [k for k in port if k.startswith(group)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k].numpy(), trajectories["want"][k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_evaluate_seg_like_matches_jax(trajectories):
    """Eval-mode loss, pixel accuracy and mean IoU over two batches on the
    trajectory's final weights."""
    from automoe_tpu.evals.segmentation import evaluate_seg_like as jax_evaluate
    from automoe_tpu.models import BDDSegmentationExpert

    from automoe_tpu_torch.evals.segmentation import evaluate_seg_like

    batches = _seg_batches(seed=11, n=2)
    model = BDDSegmentationExpert(num_classes=19)
    want = jax_evaluate(jax.jit(lambda v, x: model.apply(v, x)), trajectories["jax_final"],
                        batches, num_classes=19)
    got = evaluate_seg_like(trajectories["port"], batches, num_classes=19)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cmd,task,cache", [("bdd", "segmentation", "bdd-seg"),
                                            ("finetune-carla", "drivable", "carla")])
def test_train_cli_on_cpu(caches, tmp_path, cmd, task, cache):
    from automoe_tpu_torch.ops import auction_kernel
    from automoe_tpu_torch.train.cli import main

    n = auction_kernel.LAUNCHES["auction_solve"]
    res = main([cmd, "--task", task, "--data-root", str(caches[cache]), "--image-size", "32",
                "--batch-size", "2", "--epochs", "2", "--num-workers", "1",
                "--runs-root", str(tmp_path / "runs"), "--ckpt-root", str(tmp_path / "ckpt"),
                "--device", "cpu"])
    assert np.isfinite(res["best_val_loss"])
    assert auction_kernel.LAUNCHES["auction_solve"] == n  # no matcher on this path
    recs = [json.loads(line) for line in
            (tmp_path / "runs" / f"bdd_{task}_run" / "metrics.jsonl").read_text().splitlines()]
    vals = [r for r in recs if "val/loss" in r]
    assert len(vals) == 2 and len([r for r in recs if "train/loss_epoch" in r]) == 2
    for r in vals:
        assert 0.0 <= r["val/pixel_acc"] <= 1.0 and 0.0 <= r["val/mean_iou"] <= 1.0
    assert (tmp_path / "ckpt" / f"bdd_{task}" / "run" / "best.pt").exists()
    shutil.rmtree(tmp_path / "ckpt")  # ~0.4 GB of weights and moments
