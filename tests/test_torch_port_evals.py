"""The port's evals (automoe_tpu_torch/evals: `automoe-eval-torch`, the
detection evaluators, the plots) and its per-expert int8 path
(serving/quant.py::quantize_expert, make_expert_quant_apply) against the
JAX package on the CPU.

Both sides see the same variables: JAX's, with BatchNorm statistics moved
off their init, carried to the port by ckpt/from_jax.py and written as a
port checkpoint that `--checkpoint` loads; the JAX CLI runs with its
`_load_state` swapped for the same variables. Both read the same seeded
synthetic caches (tools/synth.py, 64 px, batch 3, two batches). The JAX
side runs at highest matmul precision (tests/conftest.py). Exact matches
fork at near ties, so the detection and nuScenes weights and caches are
seeds whose matches all survive 3e-5 relative noise on the outputs (30
draws a batch, on the CPU).

Tolerances, stated where they are used: float evals rtol 1e-4 on losses
and the gating metrics, atol 1e-5 on avg_iou / recall_0.5 / pixel_acc /
mean_iou; the int8 path on the JAX CLI's own calibration scales (the q8
trunk turns a 1e-6 change in a scale into percent-level drift), with the
port's calibration pinned apart at rtol 1e-5.
"""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automoe_tpu.evals import cli as jcli
from tests.torch_port_common import (  # noqa: F401
    _perturb_norms,
    module_tmp,
    small_config,
    tmp_path,
)

S, B = 64, 3
#: the detection head's box channels moved to boxes inside the image (the
#: CARLA boxes are in pixels), so that matched IoUs and recall are not all 0
BOX_SCALE, BOX_BIAS = 8.0, (32.0, 32.0, 20.0, 20.0)


def _vars(wl, seed):
    v = jax.device_get(wl.init_variables(jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    return {"params": _perturb_norms(v["params"], rng),
            "batch_stats": _perturb_norms(v["batch_stats"], rng)}


def _save(sd, path: Path) -> str:
    torch.save({"model_state_dict": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def setup(module_tmp):
    """Caches, JAX variables and the port checkpoints holding them."""
    from automoe_tpu.train.workloads import (
        bdd_expert_workload,
        gating_workload,
        nuscenes_workload,
    )
    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax, state_dict_from_jax
    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.tools.synth import (
        synth_carla_detection,
        synth_carla_segmentation,
        synth_carla_sequence,
        synth_nuscenes,
    )

    root = module_tmp("evals")
    out = {
        "root": root,
        "det": synth_carla_detection(root / "det", n_per_split={"val": 6}, size=S,
                                     max_boxes=4, seed=3),
        "seg": synth_carla_segmentation(root / "seg", n_per_split={"val": 6}, size=S, seed=3),
        "seq": synth_carla_sequence(root / "seq", n_per_split={"val": 16}, runs=1, size=S,
                                    seed=3),
        "nus": synth_nuscenes(root / "nus", n_per_split={"val": 6}, size=S, points=256,
                              seed=3),
    }
    det = _vars(bdd_expert_workload("detection", image_size=S), 5)
    head = det["params"]["head"]["conv2"]
    head["kernel"][..., 10:] *= BOX_SCALE
    head["bias"][10:] = BOX_BIAS
    out["vars"] = {"detection": det,
                   "drivable": _vars(bdd_expert_workload("drivable", image_size=S), 6),
                   "nuscenes": _vars(nuscenes_workload(image_size=S), 7)}
    for task, v in out["vars"].items():
        out[f"ckpt_{task}"] = _save(expert_state_dict_from_jax(v, task), root / f"{task}.pt")
    cfg = small_config()
    out["config"] = str(root / "config.json")
    Path(out["config"]).write_text(json.dumps(cfg.to_json()))
    out["vars"]["gating"] = _vars(gating_workload(cfg, image_size=S), 8)
    out["ckpt_gating"] = _save(state_dict_from_jax(out["vars"]["gating"],
                                                   load_model_config(cfg.to_json())),
                               root / "gating.pt")
    return out


class _Captured:
    """Wraps a function and keeps what it returned last."""

    def __init__(self, fn):
        self.fn, self.value = fn, None

    def __call__(self, *a, **k):
        self.value = self.fn(*a, **k)
        return self.value


def _jax_cli(setup, task, argv, patch=None):
    """The JAX CLI's `argv` on `task`'s variables; patch: (module, name)
    whose function is captured while it runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_load_state", lambda wl, path: setup["vars"][task])
        cap = None
        if patch is not None:
            cap = _Captured(getattr(*patch))
            mp.setattr(*patch, cap)
        res = jcli.main(argv)
    return res, cap


def _port_cli(setup, task, argv, out_dir, quant_patch=None):
    from automoe_tpu_torch.evals.cli import main

    argv = argv + ["--device", "cpu", "--checkpoint", setup[f"ckpt_{task}"],
                   "--out-dir", str(out_dir)]
    if quant_patch is None:
        return main(argv), None
    with pytest.MonkeyPatch.context() as mp:
        module, name, replace = quant_patch
        cap = _Captured(getattr(module, name))
        mp.setattr(module, name, lambda *a, **k: replace(cap(*a, **k)))
        return main(argv), cap


def _common(setup, cache, out_dir, extra=()):
    return ["--data-root", str(setup[cache]), "--batch-size", str(B), "--num-workers", "1",
            "--image-size", str(S), "--out-dir", str(out_dir), *extra]


def _assert_close(got, want, rtol_keys, atol_keys):
    assert sorted(got) == sorted(want)
    for k in rtol_keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in atol_keys:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def _one_file(out_dir: Path, pattern: str) -> dict:
    files = list((out_dir / "results").glob(pattern))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


# ---------------------------------------------------------------------------
# evals/detection.py
# ---------------------------------------------------------------------------

def _det_outputs(seed, b=4, h=4, w=4, n=5):
    """Dense-grid outputs whose boxes spread over the image, and GT boxes
    (two samples with padding, one with none)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, h, w, 10)).astype(np.float32)
    deltas = np.concatenate([rng.uniform(0.2, 0.8, (b, h, w, 2)),
                             rng.uniform(0.1, 0.5, (b, h, w, 2))], -1).astype(np.float32)
    xy1 = rng.uniform(0.0, 0.5, (b, n, 2))
    boxes = np.concatenate([xy1, xy1 + rng.uniform(0.1, 0.5, (b, n, 2))], -1)
    labels = rng.integers(0, 10, (b, n)).astype(np.int32)
    labels[0, 3:] = -1
    labels[1] = -1
    boxes[labels < 0] = 0
    return logits, deltas, boxes.astype(np.float32), labels


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_eval_batch_matches_jax(seed):
    from automoe_tpu.evals.detection import detection_eval_batch as jax_batch

    from automoe_tpu_torch.evals import detection_eval_batch

    logits, deltas, boxes, labels = _det_outputs(seed)
    want = jax_batch(*map(jnp.asarray, (logits, deltas, boxes, labels)), num_classes=10)
    got = detection_eval_batch(*(torch.from_numpy(a) for a in
                                 (logits.transpose(0, 3, 1, 2), deltas.transpose(0, 3, 1, 2),
                                  boxes, labels)), num_classes=10)
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    for k in ("sample_iou", "sample_recall"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["has_match"].numpy(), np.asarray(want["has_match"]))
    assert float(got["sample_iou"].max()) > 0  # the metrics are exercised


def test_evaluate_detection_matches_jax():
    """Over two batches of fixed outputs: a module-free callable on the
    port side (with device=), an apply_fn on the JAX side."""
    from automoe_tpu.evals.detection import evaluate_detection as jax_evaluate

    from automoe_tpu_torch.evals import evaluate_detection

    outs = [_det_outputs(s) for s in (2, 3)]
    batches = [{"image": np.zeros((4, 8, 8, 3), np.float32), "bboxes": o[2], "labels": o[3]}
               for o in outs]
    it = iter(outs)
    want = jax_evaluate(lambda v, img: dict(zip(("class_logits", "bbox_deltas"),
                                                map(jnp.asarray, next(it)[:2]))),
                        None, batches, num_classes=10)
    it = iter(outs)

    def forward(image):
        o = next(it)
        return {"class_logits": torch.from_numpy(o[0]).permute(0, 3, 1, 2),
                "bbox_deltas": torch.from_numpy(o[1]).permute(0, 3, 1, 2)}

    got = evaluate_detection(forward, batches, num_classes=10, device="cpu")
    _assert_close(got, want, ["val_loss"], ["avg_iou", "recall_0.5"])
    assert got["avg_iou"] > 0 and got["recall_0.5"] > 0


@pytest.mark.parametrize("name,kw", [
    ("evaluate_detection", {"num_classes": 10}),
    ("evaluate_seg_like", {"num_classes": 3}),
    ("evaluate_nuscenes", {}),
    ("evaluate_automoe", {}),
])
def test_callable_forward_needs_a_device(name, kw):
    import automoe_tpu_torch.evals as evals

    with pytest.raises(ValueError, match="device="):
        getattr(evals, name)(lambda *a: None, [], **kw)


# ---------------------------------------------------------------------------
# serving/quant.py: one expert
# ---------------------------------------------------------------------------

def _port_expert(task, variables):
    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    model = bdd_expert_workload(task).init_model(0, "cpu").eval()
    model.load_state_dict(expert_state_dict_from_jax(variables, task), strict=True)
    return model


@pytest.mark.parametrize("task", ["detection", "drivable"])
def test_quantize_expert_and_apply_match_jax(setup, task):
    """quantize_expert's scales at rtol 1e-5; make_expert_quant_apply's
    outputs on the JAX scales at the q8 trunk's tolerance
    (test_torch_port_quant.py::test_q8_trunk_matches_jax: 99.9% of the
    values within rtol / atol 1e-4)."""
    from automoe_tpu.serving import quant as jq

    from automoe_tpu_torch.serving.quant import (
        make_expert_quant_apply,
        prepare_qexpert,
        quantize_expert,
    )

    variables = setup["vars"][task]
    rng = np.random.default_rng(11)
    calib = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    jpack, jscales = jq.quantize_expert(variables, [calib], dtype=jnp.float32)
    C = {"detection": 10, "drivable": 3}[task]
    want = jq.make_expert_quant_apply(task, C, jscales, dtype=jnp.float32)(
        {"q": jpack, "params": variables["params"]}, jnp.asarray(x))

    model = _port_expert(task, variables)
    qpack, scales = quantize_expert(model, [calib], dtype=torch.float32)
    assert sorted(scales) == sorted(jscales)
    for k in jscales:
        np.testing.assert_allclose(scales[k], jscales[k], rtol=1e-5, err_msg=k)
    apply_fn = make_expert_quant_apply(task, C, jscales, dtype=torch.float32)
    got = apply_fn(model, prepare_qexpert(qpack, jscales, torch.float32, "cpu"),
                   torch.from_numpy(x).permute(0, 3, 1, 2))
    pairs = ([(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]))
              for k in ("class_logits", "bbox_deltas")] if task == "detection"
             else [(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))])
    for g, w in pairs:
        assert g.shape == w.shape
        close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
        assert close.mean() > 0.999, 1.0 - close.mean()


def test_expert_quant_apply_v1_trunk_is_not_ported():
    from automoe_tpu_torch.serving.quant import make_expert_quant_apply

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_expert_quant_apply("detection", 10, {}, trunk="v1")


# ---------------------------------------------------------------------------
# evals/plots.py
# ---------------------------------------------------------------------------

def _plot_calls(out: Path):
    from tests.torch_port_common import make_batch

    rng = np.random.default_rng(12)
    metrics = out / "metrics.jsonl"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    metrics.write_text("\n".join(json.dumps({"step": s, "time": 0.1 * s, "train/loss": 1 / (s + 1),
                                             "val/loss": 2 / (s + 1), "lr": 1e-3, "note": "x"})
                                 for s in range(6)))
    logits = rng.normal(size=(4, 4, 10)).astype(np.float32) * 3
    deltas = np.concatenate([rng.uniform(0.2, 0.8, (4, 4, 2)),
                             rng.uniform(0.1, 0.4, (4, 4, 2))], -1).astype(np.float32)
    image = np.clip(make_batch(0, b=1, s=32)["image"][0] * 0.2 + 0.5, 0, 1)
    return [
        ("plot_expert_usage", ([0.4, 0.3, 0.2, 0.1], [0.05] * 4, ["a", "b", "c", "d"],
                               str(out / "vis" / "usage.png"))),
        ("plot_training_curves", (str(metrics), str(out / "curves.png"))),
        ("plot_correlation_heatmap", (rng.uniform(-1, 1, (4, 3)), ["s", "st", "t", "b"],
                                      ["e0", "e1", "e2"], "title",
                                      str(out / "vis" / "corr.png"))),
        ("draw_detections", (image, np.array([[2, 2, 20, 20], [-1, -1, -1, -1]], np.float32),
                             np.array([[5, 5, 25, 28]], np.float32), str(out / "vis" / "d.jpg"),
                             np.array([0.9], np.float32))),
        ("topk_predictions", (logits, deltas), {"k": 5, "threshold": 0.2, "image_hw": (32, 48)}),
        ("analyze_detection_per_image",
         ([{"n_gt": 3, "n_match": 3, "mean_iou": 0.5, "recall": 2 / 3},
           {"n_gt": 0, "n_match": 0, "mean_iou": 0.0, "recall": 0.0}],
          str(out / "results" / "table.json"))),
    ]


def test_plots_match_jax(tmp_path):
    """Each of the six functions: the same files written (names and bytes),
    the same return values."""
    from automoe_tpu.evals import plots as jplots

    from automoe_tpu_torch.evals import plots

    results = {}
    for name, mod in (("jax", jplots), ("port", plots)):
        out = tmp_path / name
        results[name] = [getattr(mod, fn)(*a, **(kw[0] if kw else {}))
                         for fn, a, *kw in _plot_calls(out)]
    files = {name: sorted(p.relative_to(tmp_path / name) for p in (tmp_path / name).rglob("*")
                          if p.is_file()) for name in ("jax", "port")}
    assert files["jax"] == files["port"] and len(files["port"]) == 6
    for rel in files["port"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
    want, got = results["jax"], results["port"]
    assert got[1] == want[1] == ["train/loss", "val/loss", "lr"]
    for g, w in zip(got[4], want[4]):
        np.testing.assert_array_equal(g, w)
    assert len(got[4][1]) > 0
    assert got[5] == want[5]


def test_plots_without_matplotlib_draw_with_pil(tmp_path, monkeypatch, capsys):
    """Where matplotlib is not installed the three charts are drawn with
    PIL at the same paths (and say so); the other three functions do not
    use matplotlib."""
    from PIL import Image

    from automoe_tpu_torch.evals import plots

    monkeypatch.setattr(plots, "_pyplot", lambda: None)
    got = [getattr(plots, fn)(*a, **(kw[0] if kw else {}))
           for fn, a, *kw in _plot_calls(tmp_path)]
    assert got[1] == ["train/loss", "val/loss", "lr"]
    for rel in ("vis/usage.png", "curves.png", "vis/corr.png"):
        with Image.open(tmp_path / rel) as img:
            assert img.format == "PNG" and min(img.size) >= 200, rel
            assert len(img.convert("RGB").getcolors(1 << 16)) > 3, rel  # not blank
    assert capsys.readouterr().err.count("drawn with PIL") == 3


# ---------------------------------------------------------------------------
# automoe-eval-torch against the JAX CLI
# ---------------------------------------------------------------------------

def test_eval_cli_bdd_detection_matches_jax(setup, tmp_path):
    argv = ["bdd", "--task", "detection", "--source", "carla", "--box-cap", "4"]
    want, _ = _jax_cli(setup, "detection", argv + _common(setup, "det", tmp_path / "jax"))
    got, _ = _port_cli(setup, "detection", argv + _common(setup, "det", tmp_path / "x"),
                       tmp_path / "port")
    _assert_close(got, want, ["val_loss"], ["avg_iou", "recall_0.5"])
    assert got["quantized"] is False and got["avg_iou"] > 0 and got["recall_0.5"] > 0
    assert _one_file(tmp_path / "port", "carla_detection_*.json") == got


@pytest.mark.parametrize("task,cache,keys", [
    ("detection", "det", ["avg_iou", "recall_0.5"]),
    ("drivable", "seg", ["pixel_acc", "mean_iou"]),
])
def test_eval_cli_bdd_quantize_matches_jax(setup, tmp_path, task, cache, keys):
    """`bdd --quantize`: the port's int8 forward on the JAX CLI's own
    calibration scales (its calibration is pinned by
    test_quantize_expert_and_apply_match_jax); val_loss rtol 1e-4, the
    metrics atol 1e-5."""
    import automoe_tpu.serving.quant as jq

    import automoe_tpu_torch.serving.quant as pq

    argv = ["bdd", "--task", task, "--source", "carla", "--box-cap", "4", "--quantize"]
    want, jcap = _jax_cli(setup, task, argv + _common(setup, cache, tmp_path / "jax"),
                          patch=(jq, "quantize_expert"))
    jscales = jcap.value[1]
    got, pcap = _port_cli(setup, task, argv + _common(setup, cache, tmp_path / "x"),
                          tmp_path / "port", quant_patch=(pq, "quantize_expert",
                                                          lambda r: (r[0], jscales)))
    for k in jscales:
        np.testing.assert_allclose(pcap.value[1][k], jscales[k], rtol=1e-5, err_msg=k)
    _assert_close(got, want, ["val_loss"], keys)
    assert got["quantized"] is True


def test_eval_cli_bdd_drivable_matches_jax(setup, tmp_path):
    argv = ["bdd", "--task", "drivable", "--source", "carla"]
    want, _ = _jax_cli(setup, "drivable", argv + _common(setup, "seg", tmp_path / "jax"))
    got, _ = _port_cli(setup, "drivable", argv + _common(setup, "seg", tmp_path / "x"),
                       tmp_path / "port")
    _assert_close(got, want, ["val_loss"], ["pixel_acc", "mean_iou"])
    assert _one_file(tmp_path / "port", "carla_drivable_*.json") == got


def test_eval_cli_nuscenes_matches_jax(setup, tmp_path):
    want, _ = _jax_cli(setup, "nuscenes", ["nuscenes"] + _common(setup, "nus", tmp_path / "j"))
    got, _ = _port_cli(setup, "nuscenes", ["nuscenes"] + _common(setup, "nus", tmp_path / "x"),
                       tmp_path / "port")
    _assert_close(got, want, ["val_loss"], [])
    assert _one_file(tmp_path / "port", "nuscenes_expert_*.json") == got


GATING_SCALARS = ["ade_l1", "fde_l1", "ade_euclid", "fde_euclid", "speed_loss", "entropy"]


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "quantize"])
def test_eval_cli_gating_matches_jax(setup, tmp_path, quantize):
    """The JSON (metrics, usage, correlations) and the three plots: the
    scalar metrics at rtol 1e-4, expert usage and std at atol 1e-5 and the
    correlations (over 6 rows) at atol 1e-4. With --quantize the port's
    int8 forward runs on the JAX CLI's own scales (its calibration pinned
    here at rtol 1e-5); a rounding flip in one of the four int8 trunks may
    move usage and correlations, so those two are held at atol 1e-4 and
    1e-3 there."""
    import automoe_tpu.serving as jserving

    import automoe_tpu_torch.serving.quant as pq

    argv = ["gating", "--model-config", setup["config"]] + (["--quantize"] if quantize else [])
    want, jcap = _jax_cli(setup, "gating", argv + _common(setup, "seq", tmp_path / "jax"),
                          patch=(jserving, "quantize_automoe") if quantize else None)
    patch = None
    if quantize:
        jscales = jcap.value["scales"]
        patch = (pq, "quantize_automoe", lambda r: {**r, "scales": jscales})
    got, pcap = _port_cli(setup, "gating", argv + _common(setup, "seq", tmp_path / "x"),
                          tmp_path / "port", quant_patch=patch)
    if quantize:
        for g, w in zip(pcap.value["scales"], jscales):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    assert sorted(got) == sorted(want)
    for k in GATING_SCALARS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("expert_usage", "expert_std"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 if quantize else 1e-5, err_msg=k)
    for k in ("pearson", "spearman"):
        np.testing.assert_allclose(got["correlation"][k], want["correlation"][k],
                                   atol=1e-3 if quantize else 1e-4, err_msg=k)
    assert got["quantized"] is quantize
    vis = sorted(p.name for p in (tmp_path / "port" / "vis").iterdir())
    assert vis == sorted(p.name for p in (tmp_path / "jax" / "vis").iterdir()) == [
        "context_corr_pearson.png", "context_corr_spearman.png", "expert_usage.png"]
    saved = _one_file(tmp_path / "port", "gating_*.json")
    assert saved == json.loads(json.dumps(got))


def test_eval_cli_training_curves_matches_jax(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "metrics.jsonl").write_text("\n".join(
        json.dumps({"step": s, "train/loss": 1.0 / (s + 1), "val/loss": 0.5 + s})
        for s in range(5)))
    from automoe_tpu_torch.evals.cli import main

    want = jcli.main(["training-curves", "--run-dir", str(run), "--out",
                      str(tmp_path / "jax.png"), "--tags", "val/loss,train/loss"])
    got = main(["training-curves", "--run-dir", str(run), "--out", str(tmp_path / "port.png"),
                "--tags", "val/loss,train/loss"])
    assert got["tags"] == want["tags"] == ["val/loss", "train/loss"]
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    default = main(["training-curves", "--run-dir", str(run)])
    assert default == {"plot": str(run / "training_curves.png"),
                       "tags": ["train/loss", "val/loss"]}
    assert (run / "training_curves.png").is_file()


def test_eval_cli_visualize_detection_matches_jax(setup, tmp_path):
    argv = ["visualize-detection", "--source", "carla", "--box-cap", "4", "--max-images", "5",
            "--threshold", "0.1"]
    want, _ = _jax_cli(setup, "detection", argv + _common(setup, "det", tmp_path / "jax"))
    got, _ = _port_cli(setup, "detection", argv + _common(setup, "det", tmp_path / "x"),
                       tmp_path / "port")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert (g["index"], g["n_gt"], g["n_match"]) == (w["index"], w["n_gt"], w["n_match"])
        np.testing.assert_allclose([g["mean_iou"], g["recall_0.5"]],
                                   [w["mean_iou"], w["recall_0.5"]], atol=1e-5)
    names = {n: sorted(p.name for p in (tmp_path / n / "vis").iterdir()) for n in ("jax", "port")}
    assert names["port"] == names["jax"] == [f"det_{i:04d}.jpg" for i in range(5)]
    assert _one_file(tmp_path / "port", "detection_per_image_*.json") == got


def test_eval_cli_needs_a_gpu_unless_asked_for_the_cpu(setup, monkeypatch, tmp_path):
    from automoe_tpu_torch.evals.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["bdd", "--task", "detection", "--source", "carla"], ["nuscenes"],
                 ["gating"], ["visualize-detection", "--source", "carla"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv + ["--data-root", str(setup["det"]), "--out-dir", str(tmp_path)])


def test_eval_cli_nuscenes_builds_the_checkpoints_tnets(tmp_path):
    """A --use-tnet checkpoint is evaluated with its TNets (the JAX CLI
    would build the default expert without them and drop their weights):
    the CLI's val_loss equals evaluate_nuscenes on the checkpoint's own
    model."""
    from automoe_tpu_torch.evals import evaluate_nuscenes
    from automoe_tpu_torch.evals.cli import main
    from automoe_tpu_torch.data import get_nuscenes_loader
    from automoe_tpu_torch.tools.synth import synth_nuscenes
    from automoe_tpu_torch.train.workloads import nuscenes_workload

    root = synth_nuscenes(tmp_path / "nus", n_per_split={"val": 3}, size=S, points=64, seed=4)
    model = nuscenes_workload(use_tnet=True).init_model(2, "cpu").eval()
    ckpt = _save(model.state_dict(), tmp_path / "tnet.pt")
    got = main(["nuscenes", "--data-root", str(root), "--checkpoint", ckpt, "--batch-size",
                str(B), "--num-workers", "1", "--device", "cpu", "--out-dir",
                str(tmp_path / "out")])
    loader = get_nuscenes_loader(split="val", batch_size=B, num_workers=1, shuffle=False,
                                 root_dir=str(root))
    want = evaluate_nuscenes(model, loader)
    assert got == want
    # the callable form (any forward with the module's inputs and outputs)
    assert evaluate_nuscenes(lambda image, lidar: model(image, lidar), loader,
                             device="cpu") == want
