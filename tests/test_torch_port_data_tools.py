"""The port's data tools against the JAX package's on the CPU, on the same
inputs:

* `synth_raw_carla`: every file byte for byte the JAX writer's for one
  seed; `synth_bdd`: the same files in two processes with different
  string-hash seeds (the JAX writer keys its generator by python's
  per-process `hash(task)`, so its output differs from the port's by
  design);
* `preprocess_carla` (at 256, and at 64 where JAX patches its module
  global and the port passes `--out_size`) and `preprocess_bdd100k`
  (detection JSON, segmentation and drivable mask walks): every cache
  equal to JAX's, tensor for tensor;
* `camera.py` on random poses and boxes: exactly JAX's arrays;
* `collect_run` on tests/carla_stub.py, full rig and `--legacy`, with
  python's `random` seeded alike: every file byte for byte JAX's;
* `redo_preprocess`, and `preprocess_nuscenes` without the devkit.
The JAX package's outputs are made once, in one module fixture."""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)

RUNS = ("run_001", "run_002")


def _files(root: Path):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _same_tree_bytes(a: Path, b: Path):
    assert _files(a) == _files(b) and _files(a)
    for rel in _files(a):
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _same(x, y, path=""):
    """Nested cache values equal: tensors exactly, dicts key by key."""
    if isinstance(x, dict):
        assert sorted(x) == sorted(y), path
        for k in x:
            _same(x[k], y[k], f"{path}/{k}")
    elif torch.is_tensor(x):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    else:
        assert x == y, path


def _same_caches(a: Path, b: Path):
    assert _files(a) == _files(b) and _files(a)
    for rel in _files(a):
        _same(torch.load(a / rel, weights_only=False), torch.load(b / rel, weights_only=False),
              str(rel))


def _bdd_raw(root: Path, rng) -> Path:
    """A tiny BDD100K raw tree: detection JSONs (with an unknown category
    and a box-less label), and segmentation / drivable mask folders."""
    from PIL import Image

    for split in ("train", "val"):
        (root / "images" / "100k" / split).mkdir(parents=True)
        ann = []
        for i in range(3):
            ann.append({"name": f"{split}{i}.jpg",
                        "attributes": {"scene": "city street", "weather": "clear"},
                        "labels": [{"category": "car",
                                    "box2d": {"x1": 1 + i, "y1": 2, "x2": 20, "y2": 25}},
                                   {"category": "sky", "box2d": {"x1": 0, "y1": 0, "x2": 5,
                                                                 "y2": 5}},
                                   {"category": "person", "poly2d": []}]})
        ann.append({"name": f"{split}_empty.jpg", "labels": []})  # skipped: no boxes
        labels = root / "labels" / "detection2020"
        labels.mkdir(parents=True, exist_ok=True)
        (labels / f"det_{split}.json").write_text(json.dumps(ann))
        for task in ("segmentation", "drivable"):
            d = root / "labels" / task / split
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 19, (12, 16), dtype=np.uint8)).save(
                    d / f"{split}_{task}{i}.png")
    return root


@pytest.fixture(scope="module")
def jax_out(module_tmp):
    """The JAX package's synth, preprocessing and collector outputs."""
    from automoe_tpu.tools import preprocess_bdd100k, preprocess_carla
    from automoe_tpu.tools.collect_carla import collect_run
    from automoe_tpu.tools.synth import synth_raw_carla
    from tests.carla_stub import install

    root = module_tmp("jax")
    out = {"raw": synth_raw_carla(root / "raw", runs=RUNS, n_frames=3, seed=7)}
    preprocess_carla.main(["--raw_dir", str(out["raw"]), "--out_dir", str(root / "pre256")])
    size = preprocess_carla.OUT_SIZE
    try:
        preprocess_carla.OUT_SIZE = 64
        preprocess_carla.main(["--raw_dir", str(out["raw"]), "--out_dir", str(root / "pre64")])
    finally:
        preprocess_carla.OUT_SIZE = size
    out["pre"] = {256: root / "pre256", 64: root / "pre64"}
    out["bdd_raw"] = _bdd_raw(root / "bdd_raw", np.random.default_rng(3))
    for task in ("detection", "segmentation", "drivable"):
        preprocess_bdd100k.main(["--task", task, "--raw_dir", str(out["bdd_raw"]),
                                 "--out_dir", str(root / "bdd_pre")])
    out["bdd_pre"] = root / "bdd_pre"
    before = sys.modules.get("carla")
    try:
        carla = install()
        out["collect"] = {}
        for legacy in (False, True):
            random.seed(11)
            d = root / f"collect_{legacy}"
            collect_run(carla.Client(), 1, _collect_args(d, legacy))
            out["collect"][legacy] = d
    finally:  # the stub stays importable for no other test
        if before is None:
            sys.modules.pop("carla", None)
        else:
            sys.modules["carla"] = before
    return out


def _collect_args(out: Path, legacy: bool):
    return argparse.Namespace(runs=1, duration=1.0, vehicles=3, walkers=2, output=str(out),
                              save_every=5, legacy=legacy)


def test_synth_raw_carla_is_byte_equal_to_jax(jax_out, tmp_path):
    from automoe_tpu_torch.tools.synth import synth_raw_carla

    got = synth_raw_carla(tmp_path / "raw", runs=RUNS, n_frames=3, seed=7)
    _same_tree_bytes(jax_out["raw"], got)


SYNTH_BDD = """
import sys
from automoe_tpu_torch.tools.synth import synth_bdd
for task in ("detection", "segmentation", "drivable"):
    synth_bdd(sys.argv[1], task=task, n_per_split={"train": 3, "val": 2}, size=32, seed=5)
"""


def test_synth_bdd_is_equal_across_processes(tmp_path):
    outs = []
    for hash_seed in ("1", "2"):
        out = tmp_path / f"p{hash_seed}"
        subprocess.run([sys.executable, "-c", SYNTH_BDD, str(out)], check=True, timeout=120,
                       env={**os.environ, "PYTHONHASHSEED": hash_seed})
        outs.append(out)
    a, b = outs
    assert _files(a) == _files(b)
    for rel in _files(a):
        if rel.suffix == ".png":
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
            continue
        x, y = (torch.load(r / rel, weights_only=False) for r in (a, b))
        # the samples name their files under their own root
        assert {k: Path(v).relative_to(a) for k, v in x.items() if k.endswith("_path")} == \
            {k: Path(v).relative_to(b) for k, v in y.items() if k.endswith("_path")}
        _same({k: v for k, v in x.items() if not k.endswith("_path")},
              {k: v for k, v in y.items() if not k.endswith("_path")}, str(rel))
    det = torch.load(a / "detection" / "train" / "00000.pt", weights_only=False)
    assert det["bboxes"].shape[1] == 4 and len(det["labels"]) == len(det["bboxes"]) >= 1


@pytest.mark.parametrize("size", [256, 64])
def test_preprocess_carla_matches_jax(jax_out, tmp_path, size):
    from automoe_tpu_torch.tools.preprocess_carla import main

    main(["--raw_dir", str(jax_out["raw"]), "--out_dir", str(tmp_path / "pre"),
          "--out_size", str(size)])
    _same_caches(jax_out["pre"][size], tmp_path / "pre")
    assert (tmp_path / "pre" / "train" / "run_001").is_dir()
    assert (tmp_path / "pre" / "val" / "run_002").is_dir()
    frame = torch.load(tmp_path / "pre" / "train" / "run_001" / "000000.pt", weights_only=False)
    assert tuple(frame["image"].shape) == (3, size, size)
    assert tuple(frame["mask"].shape) == (size, size)


def test_preprocess_bdd100k_matches_jax(jax_out, tmp_path):
    from automoe_tpu_torch.tools.preprocess_bdd100k import main

    for task in ("detection", "segmentation", "drivable"):
        main(["--task", task, "--raw_dir", str(jax_out["bdd_raw"]), "--out_dir",
              str(tmp_path / "pre")])
    _same_caches(jax_out["bdd_pre"], tmp_path / "pre")
    # the box-less image is skipped, the unknown category dropped
    assert len(list((tmp_path / "pre" / "detection" / "train").glob("*.pt"))) == 3


def test_camera_matches_jax_on_random_poses():
    from automoe_tpu.tools import camera as jax_camera

    from automoe_tpu_torch.tools import camera

    rng = np.random.default_rng(0)
    for _ in range(20):
        w, h, fov = int(rng.integers(64, 1024)), int(rng.integers(64, 1024)), rng.uniform(40, 120)
        pose = rng.uniform(-50, 50, 3), rng.uniform(-180, 180, 3)
        box = rng.uniform(-30, 30, 3) + [15, 0, 0], rng.uniform(0.3, 3, 3), rng.uniform(
            -180, 180, 3)
        pts = rng.normal(size=(16, 3)) * 10
        for name, args in (("build_camera_intrinsic", (w, h, fov)),
                           ("rotation_matrix", tuple(pose[1])),
                           ("world_to_camera_matrix", pose),
                           ("box_world_vertices", box)):
            np.testing.assert_array_equal(getattr(camera, name)(*args),
                                          getattr(jax_camera, name)(*args), err_msg=name)
        K = camera.build_camera_intrinsic(w, h, fov)
        np.testing.assert_array_equal(camera.project_points(K, pts),
                                      jax_camera.project_points(K, pts))
        w2c = camera.world_to_camera_matrix(*pose)
        verts = camera.box_world_vertices(*box)
        assert camera.compute_2d_bbox(verts, K, w2c, w, h) == jax_camera.compute_2d_bbox(
            verts, K, w2c, w, h)


@pytest.mark.parametrize("legacy", [False, True], ids=["full-rig", "legacy"])
def test_collect_run_matches_jax_on_the_stub(jax_out, tmp_path, legacy, monkeypatch):
    from automoe_tpu_torch.tools.collect_carla import CAMERA_RIG, collect_run
    from tests.carla_stub import install

    monkeypatch.setitem(sys.modules, "carla", None)  # undone at teardown
    carla = install()
    random.seed(11)
    client = carla.Client()
    metrics = collect_run(client, 1, _collect_args(tmp_path, legacy))
    assert metrics["n_frames"] > 0
    _same_tree_bytes(jax_out["collect"][legacy], tmp_path)
    run = tmp_path / "run_001"
    if legacy:
        assert all(list((run / "images" / cam).glob("*.png")) for cam in CAMERA_RIG)
        assert not (run / "lidar").exists()
    else:
        labels = {b["label"] for f in (run / "annots/front").glob("*.json")
                  for b in json.loads(f.read_text())["boxes"]}
        assert labels == {"vehicle", "pedestrian"}
    assert client.get_world().get_settings().synchronous_mode is False


def test_redo_preprocess(tmp_path, capsys):
    from automoe_tpu_torch.tools.redo_preprocess import main as redo

    target = tmp_path / "datasets" / "carla" / "preprocessed"
    target.mkdir(parents=True)
    (target / "x.pt").write_bytes(b"1")
    redo(["carla", "nuscenes", "--base", str(tmp_path), "--dry-run"])
    assert target.exists()
    redo(["all", "--base", str(tmp_path)])
    assert not target.exists()
    out = capsys.readouterr().out
    assert "carla: would remove" in out and "carla: removed" in out
    assert "nuscenes: nothing at" in out


def test_preprocess_nuscenes_without_the_devkit(tmp_path, monkeypatch):
    from automoe_tpu_torch.data.datasets import boxes_to_arrays
    from automoe_tpu_torch.tools import preprocess_nuscenes

    assert preprocess_nuscenes.boxes_to_arrays is boxes_to_arrays
    monkeypatch.setitem(sys.modules, "nuscenes", None)  # absent even where installed
    with pytest.raises(SystemExit, match="nuscenes-devkit is required"):
        preprocess_nuscenes.main(["--dataroot", str(tmp_path), "--out_dir",
                                  str(tmp_path / "out")])
