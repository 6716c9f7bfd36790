"""The port's packed caches against the JAX package's, on the CPU:

* `automoe-pack-torch` for each of its eight tasks writes files
  byte-identical to the JAX package's `automoe-pack` on the same synthetic
  dataset (every `.npy` and `index.json`);
* the port's native reader (csrc/packed_reader.cpp, built with g++) and
  its python readers return arrays identical (values and dtypes) to the
  JAX package's native reader on the same caches and indices; float16
  inf, NaN, -0 and subnormals widen as JAX's do;
* a bad index, a missing cache and a failed build raise (no silent
  fallback to the python reader), and a box-cap mismatch raises;
* the DataLoader gathers a dataset with `read_batch` a batch at a time;
* `finetune-carla --task detection --packed-root` on the CPU equals, bit
  for bit, the port's Trainer fed the python `PackedFrameDataset` of the
  same cache.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)

S = 40  # 40·40·3 = 4800 elements: images are packed float16


def _synth(task: str, root):
    from automoe_tpu_torch.tools import synth

    split = {"train": 6, "val": 3}
    if task == "bdd-detection":
        return synth.synth_bdd_detection(root, n_per_split=split, size=S, max_boxes=4, seed=1)
    if task in ("bdd-segmentation", "bdd-drivable"):
        return synth.synth_bdd_segmentation(root, task=task[4:], n_per_split=split, size=S,
                                            seed=2)
    if task == "nuscenes":
        return synth.synth_nuscenes(root, n_per_split=split, size=S, points=48, max_boxes=5,
                                    seed=3)
    if task == "carla-detection":
        return synth.synth_carla_detection(root, n_per_split=split, size=S, max_boxes=4, seed=4)
    if task in ("carla-segmentation", "carla-drivable"):
        return synth.synth_carla_segmentation(root, n_per_split=split, size=S, seed=5)
    return synth.synth_carla_sequence(root, n_per_split={"train": 16, "val": 12}, size=S,
                                      seed=6)


def _pack_args(task: str, root, out):
    args = [task, "--root", str(root), "--out", str(out), "--box-cap", "5"]
    if task == "nuscenes":
        args += ["--lidar-cap", "40"]
    if task == "carla-sequences":
        args += ["--horizon", "4"]
    return args


@pytest.mark.parametrize("task", ["bdd-detection", "bdd-segmentation", "bdd-drivable",
                                  "nuscenes", "carla-detection", "carla-segmentation",
                                  "carla-drivable", "carla-sequences"])
def test_pack_cli_writes_jax_bytes(task, tmp_path):
    from automoe_tpu.data.pack_cli import main as jax_pack

    from automoe_tpu_torch.data.pack_cli import main as pack

    root = _synth(task, tmp_path / "data")
    counts = pack(_pack_args(task, root, tmp_path / "port"))
    assert counts == jax_pack(_pack_args(task, root, tmp_path / "jax"))
    assert min(counts.values()) > 0
    for split in ("train", "val"):
        mine, ref = tmp_path / "port" / split, tmp_path / "jax" / split
        names = sorted(p.name for p in ref.iterdir())
        assert names == sorted(p.name for p in mine.iterdir()) and "index.json" in names
        for name in names:
            assert (mine / name).read_bytes() == (ref / name).read_bytes(), (split, name)


@pytest.fixture(scope="module")
def caches(module_tmp):
    """Port-packed train caches: BDD detection, nuScenes, CARLA sequences."""
    from automoe_tpu_torch.data.pack_cli import main as pack

    base = module_tmp("packed")
    out = {}
    for task in ("bdd-detection", "nuscenes", "carla-sequences"):
        pack(_pack_args(task, _synth(task, base / task), base / f"{task}-packed"))
        out[task] = base / f"{task}-packed" / "train"
    return out


@pytest.mark.parametrize("task", ["bdd-detection", "nuscenes", "carla-sequences"])
def test_readers_match_jax_native_reader(caches, task):
    from automoe_tpu.data.native_packed import NativePackedDataset as JaxNative

    from automoe_tpu_torch.data.native_packed import NativePackedDataset
    from automoe_tpu_torch.data.packed import PackedFrameDataset, PackedSequenceDataset

    d = caches[task]
    ref = JaxNative(d)
    idx = [3, 0, len(ref) - 1, 3, 1]
    want = ref.read_batch(idx)
    python = PackedSequenceDataset(d) if task == "carla-sequences" else PackedFrameDataset(d)
    for reader in (NativePackedDataset(d), python):
        assert len(reader) == len(ref)
        got = reader.read_batch(idx)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, (k, got[k].dtype)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    one = NativePackedDataset(d)[2]
    for k in want:
        np.testing.assert_array_equal(one[k], ref[2][k], err_msg=k)
    if task == "carla-sequences":
        assert one["meta"] == ref[2]["meta"] == python[2]["meta"]


def test_f16_special_values_widen_as_jax(tmp_path):
    from automoe_tpu.data.native_packed import NativePackedDataset as JaxNative

    from automoe_tpu_torch.data.native_packed import NativePackedDataset

    sp = np.array([6e-8, 5.96e-8, np.inf, -np.inf, np.nan, -0.0, 65504.0, -1.5], np.float16)
    img = np.tile(sp, (4, 18)).reshape(4, 12, 12).astype(np.float16)
    np.save(tmp_path / "image.npy", img)
    (tmp_path / "index.json").write_text(json.dumps({"n": 4, "meta": []}))
    got = NativePackedDataset(tmp_path).read_batch([0, 3])["image"]
    want = JaxNative(tmp_path).read_batch([0, 3])["image"]
    ref = img[[0, 3]].astype(np.float32)
    for other in (want, ref):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(other))
        m = ~np.isnan(other)
        np.testing.assert_array_equal(got[m], other[m])
        np.testing.assert_array_equal(np.signbit(got[m]), np.signbit(other[m]))


def test_native_reader_raises(caches, tmp_path):
    from automoe_tpu_torch.data.native_packed import NativePackedDataset

    nat = NativePackedDataset(caches["bdd-detection"])
    with pytest.raises(ValueError, match="pr_read_batch"):
        nat.read_batch([0, len(nat)])
    with pytest.raises(ValueError, match="pr_read_batch"):
        nat.read_batch([-1])
    with pytest.raises(FileNotFoundError):
        NativePackedDataset(tmp_path)  # no .npy there
    nat.close()
    with pytest.raises(ValueError, match="closed"):
        nat.read_batch([0])


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path, caches):
    from automoe_tpu_torch.data import factories, native_packed
    from automoe_tpu_torch.ops import _ext

    (tmp_path / "packed_reader.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(_ext, "CSRC", tmp_path)
    monkeypatch.setattr(_ext, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_ext, "_libs", {})
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native_packed.load_library()
    # the factory does not fall back to the python reader
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        factories.get_bdd_detection_loader(packed_root=caches["bdd-detection"].parent,
                                           box_cap=5)


class _BatchOnly:
    """A dataset that can only be read a whole batch at a time."""

    def __init__(self, n=10):
        self.x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        self.calls = []

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        raise AssertionError("the loader must not read sample by sample")

    def read_batch(self, idx):
        self.calls.append(list(idx))
        return {"x": self.x[np.asarray(idx)]}


def test_loader_takes_the_read_batch_path():
    from automoe_tpu_torch.data.loader import DataLoader

    ds = _BatchOnly()
    dl = DataLoader(ds, batch_size=4, shuffle=True, seed=3, drop_last=False, num_workers=2)
    dl.set_epoch(1)
    got = list(dl)
    assert len(got) == len(ds.calls) == 3
    for b, idx in zip(got, ds.calls):
        np.testing.assert_array_equal(b["x"], ds.x[idx])
    assert got[-1]["_real_count"] == 2 and "_real_count" not in got[0]
    assert sorted(np.concatenate([c[:r] for c, r in zip(ds.calls, (4, 4, 2))])) == list(range(10))


def test_packed_loader_matches_the_preprocessed_loader(tmp_path):
    """The detection factory over a packed cache yields the batches of the
    same factory over the preprocessed dataset."""
    from automoe_tpu_torch.data import get_carla_detection_loader
    from automoe_tpu_torch.data.pack_cli import main as pack
    from automoe_tpu_torch.data.packed import _pack_dtype

    root = _synth("carla-detection", tmp_path / "data")
    pack(_pack_args("carla-detection", root, tmp_path / "packed"))
    kw = dict(batch_size=2, num_workers=1, seed=4, box_cap=5)
    for split in ("train", "val"):
        a = get_carla_detection_loader(split, packed_root=str(tmp_path / "packed"), **kw)
        b = get_carla_detection_loader(split, root_dir=str(root), **kw)
        a.set_epoch(2)
        b.set_epoch(2)
        for x, y in zip(list(a), list(b), strict=True):
            assert sorted(x) == sorted(y)
            # stored as the packer stores it (f16 from 4096 elements a row)
            stored = _pack_dtype("image", y["image"][0])
            np.testing.assert_array_equal(x["image"], y["image"].astype(stored).astype(
                np.float32))
            for k in ("bboxes", "labels", "_real_count"):
                if k in y:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_cap_mismatch_raises(caches):
    from automoe_tpu_torch.data import get_bdd_detection_loader, get_carla_sequence_loader

    root = caches["bdd-detection"].parent
    assert len(get_bdd_detection_loader(packed_root=root, box_cap=5, batch_size=2)) == 3
    with pytest.raises(ValueError, match="bboxes leading dim 5"):
        get_bdd_detection_loader(packed_root=root, box_cap=48)
    with pytest.raises(ValueError, match="waypoints leading dim 4"):
        get_carla_sequence_loader(packed_root=caches["carla-sequences"].parent, horizon=8)


def test_finetune_carla_packed_equals_trainer_on_python_reader(tmp_path):
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.data.loader import DataLoader
    from automoe_tpu_torch.data.pack_cli import main as pack
    from automoe_tpu_torch.data.packed import PackedFrameDataset
    from automoe_tpu_torch.train.cli import main
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    root = _synth("carla-detection", tmp_path / "data")
    packed = tmp_path / "packed"
    pack(_pack_args("carla-detection", root, packed))
    res = main(["finetune-carla", "--task", "detection", "--packed-root", str(packed),
                "--image-size", str(S), "--box-cap", "5", "--batch-size", "2", "--epochs", "2",
                "--num-workers", "1", "--device", "cpu", "--ckpt-root", str(tmp_path / "ck"),
                "--runs-root", str(tmp_path / "runs")])
    cli_sd = load_checkpoint(tmp_path / "ck" / "bdd_detection" / "run" / "last.pt")

    train = DataLoader(PackedFrameDataset(packed / "train"), batch_size=2, shuffle=True,
                       num_workers=1, drop_last=True)
    val = DataLoader(PackedFrameDataset(packed / "val"), batch_size=2, shuffle=False,
                     num_workers=1, drop_last=False)
    cfg = TrainConfig(epochs=2, learning_rate=2e-4, weight_decay=1e-5, run_name="py",
                      ckpt_root=str(tmp_path / "ck2"), runs_root=str(tmp_path / "runs2"),
                      device="cpu")
    trainer = Trainer(bdd_expert_workload("detection", bbox_loss_weight=1.0), train, val, cfg)
    ref = trainer.fit()
    assert res["best_val_loss"] == ref["best_val_loss"]
    sd = trainer.model.state_dict()
    assert sorted(sd) == sorted(cli_sd["model_state_dict"])
    for k, v in sd.items():
        assert torch.equal(cli_sd["model_state_dict"][k], v), k
