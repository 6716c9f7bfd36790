"""The port's frozen-expert feature cache (train/feature_cache.py) and the
gating trainer's `experts_eval` / `cached_pooled` paths, on the CPU:

* `automoe_pooled_features` on `from_jax` weights matches the JAX
  package's (rtol 1e-4 / atol 1e-5, the eval-mode tolerances of
  tests/test_torch_port_gating.py at 64 px);
* the `experts_eval` gating step matches JAX's (`experts_eval=True`, dropout
  off): loss rtol 1e-4 / atol 1e-6, trainable gradients rtol 1e-4 / atol
  1e-5, the moving BatchNorm statistics rtol 1e-4 / atol 1e-6, while the
  experts' statistics stay put and the experts keep the model's mode;
* a cached AdamW step equals the `experts_eval` step, as JAX's
  tests/test_feature_cache.py holds its own: loss rtol 1e-5, trained
  parameters rtol 1e-3 / atol 1e-4, the experts' parameters and buffers
  bit-equal to the start;
* the cached loss depends on the image's pixels (the policy head's own
  backbone reads them);
* `PooledFeatureDataset` carries the features through `read_batch`, and
  `precompute_pooled_features` pads and slices its tail batch;
* the `--feature-cache-dir` fingerprint moves with the expert weights, the
  length and the tag only; a cache written once is loaded after;
* the CLI's guards, and `gating --packed-root --cache-expert-features`
  with and without `--device-resident` on the CPU.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms
from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)

# 64 px: see tests/test_torch_port_gating.py (at 32 px JAX's BatchNorm
# variance breaks the tolerances)
S, H, B = 64, 4, 2
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
    "policy": {"num_waypoints": H},
}
LCFG = {"speed_weight": 0.3, "load_balancing_weight": 0.05}


def _batch(seed: int, b: int = B):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(b, S, S, 3)).astype(np.float32),
        "speed": rng.uniform(0, 30, (b, H)).astype(np.float32),
        "steering": (rng.normal(size=(b, H)) * 0.2).astype(np.float32),
        "throttle": rng.uniform(0, 1, (b, H)).astype(np.float32),
        "brake": (rng.uniform(0, 1, (b, H)) < 0.2).astype(np.float32),
        "waypoints": (rng.normal(size=(b, H, 2)) * 3).astype(np.float32),
    }


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_ee():
    """JAX's experts_eval gating workload from perturbed init weights: one
    jitted value-and-grad in train mode, dropout off, and its pooled
    features, on one batch."""
    from automoe_tpu.losses import gating_losses
    from automoe_tpu.models.automoe import automoe_pooled_features
    from automoe_tpu.train.workloads import gating_workload

    wl = gating_workload(MODEL_CFG, image_size=S, experts_eval=True)
    v = jax.device_get(wl.init_variables(jax.random.key(0)))
    rng = np.random.default_rng(21)
    init = {"params": _perturb_norms(v["params"], rng),
            "batch_stats": _perturb_norms(v["batch_stats"], rng)}

    def loss(params, stats, batch):
        out, upd = wl.model.apply({"params": params, "batch_stats": stats}, batch, train=True,
                                  deterministic=True, experts_eval=True,
                                  mutable=["batch_stats"])
        res = gating_losses(out, batch["waypoints"], batch["speed"], LCFG)
        return res["total_loss"], (res, upd["batch_stats"])

    batch = _batch(5)
    (lv, (res, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        init["params"], init["batch_stats"], batch)
    pooled = jax.jit(lambda v, b: automoe_pooled_features(wl.model, v, b))(init, batch)
    return {"init": init, "batch": batch, "res": jax.device_get(res),
            "grads": jax.device_get(grads), "stats": jax.device_get(stats),
            "pooled": [np.asarray(p) for p in pooled]}


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def _port_model(init, **kw):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.train.workloads import gating_workload

    wl = gating_workload(MODEL_CFG, loss_config=LCFG, **kw)
    model = wl.init_model(0, "cpu")
    model.load_state_dict(state_dict_from_jax(init, MODEL_CFG), strict=True)
    return wl, model


def test_pooled_features_match_jax(jax_ee):
    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.models import automoe_pooled_features
    from automoe_tpu_torch.train.workloads import pooled_feature_dim

    _, model = _port_model(jax_ee["init"])
    got = automoe_pooled_features(model, _tb(jax_ee["batch"]))
    dims = [pooled_feature_dim(e) for e in load_model_config(MODEL_CFG).experts]
    assert [tuple(p.shape) for p in got] == [(B, d) for d in dims]
    assert all(p.dtype == torch.float32 for p in got)
    assert model.training and model.experts.training  # the mode is restored
    for i, (p, w) in enumerate(zip(got, jax_ee["pooled"])):
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=f"expert {i}")


def test_experts_eval_step_matches_jax(jax_ee):
    from automoe_tpu_torch.ckpt import state_dict_from_jax

    wl, model = _port_model(jax_ee["init"], experts_eval=True)
    _no_dropout(model).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, metrics = wl.loss_fn(model, _tb(jax_ee["batch"]), True)
    loss.backward()
    assert model.experts.training  # the loop's model.train() holds outside the forward
    res = jax_ee["res"]
    np.testing.assert_allclose(float(loss.detach()), float(res["total_loss"]), rtol=1e-4,
                               atol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(res[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want_g = state_dict_from_jax({"params": jax_ee["grads"]}, MODEL_CFG)
    n = 0
    for name, p in model.named_parameters():
        if name.startswith("experts."):
            assert p.grad is None, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        n += 1
    assert n > 0
    want_s = state_dict_from_jax({"params": jax_ee["init"]["params"],
                                  "batch_stats": jax_ee["stats"]}, MODEL_CFG)
    moved = 0
    for name, t in model.state_dict().items():
        if name.startswith("experts."):
            assert torch.equal(t, before[name]), name  # frozen BN: nothing moves
        elif name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want_s[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            moved += not torch.equal(t, before[name])
    assert moved > 0  # the policy backbone's BatchNorms train


def _step(wl, model, batch, key=(7, 0)):
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step

    opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, weight_decay=1e-4,
                         total_steps=10, trainable_mask=wl.trainable_mask(model))
    return make_train_step(wl.loss_fn)(model, opt, batch, key)


def test_cached_step_equals_experts_eval_step(jax_ee):
    from automoe_tpu_torch.models import automoe_pooled_features
    from automoe_tpu_torch.train.feature_cache import pooled_keys

    wl_ee, m_ee = _port_model(jax_ee["init"], experts_eval=True)
    wl_c, m_c = _port_model(jax_ee["init"], cache_features=True)
    start = {k: v.clone() for k, v in m_c.state_dict().items()}
    batch = _tb(jax_ee["batch"])
    cached = dict(batch, **dict(zip(pooled_keys(4), automoe_pooled_features(m_c, batch))))
    out_ee, out_c = _step(wl_ee, m_ee, batch), _step(wl_c, m_c, cached)  # dropout live
    np.testing.assert_allclose(float(out_c["loss"]), float(out_ee["loss"]), rtol=1e-5)
    sd_ee, sd_c = m_ee.state_dict(), m_c.state_dict()
    assert sorted(sd_ee) == sorted(sd_c)
    for name, t in sd_c.items():
        if name.startswith("experts."):
            assert torch.equal(t, start[name]) and torch.equal(sd_ee[name], start[name]), name
        elif t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), sd_ee[name].numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=name)


def test_cached_loss_depends_on_image_pixels(jax_ee):
    from automoe_tpu_torch.models import automoe_pooled_features
    from automoe_tpu_torch.train.feature_cache import pooled_keys

    wl, model = _port_model(jax_ee["init"], cache_features=True)
    batch = _tb(jax_ee["batch"])
    cached = dict(batch, **dict(zip(pooled_keys(4), automoe_pooled_features(model, batch))))
    with torch.no_grad():
        l1 = float(wl.loss_fn(_no_dropout(model), cached, True)[0])
        l2 = float(wl.loss_fn(model, dict(cached, image=cached["image"] + 0.5), True)[0])
    assert abs(l1 - l2) > 1e-6, "the cached loss ignored the image"


class _Rows:
    def __init__(self, n, batch=False):
        self.images = np.random.default_rng(n).normal(size=(n, S, S, 3)).astype(np.float32)
        if batch:
            self.read_batch = lambda idx: {"image": self.images[np.asarray(idx)]}

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "meta": {"i": i}}


def test_pooled_feature_dataset_and_precompute(jax_ee):
    from automoe_tpu_torch.models import automoe_pooled_features
    from automoe_tpu_torch.train.feature_cache import (PooledFeatureDataset,
                                                       precompute_pooled_features)

    _, model = _port_model(jax_ee["init"])
    rows, batched = _Rows(5), _Rows(5, batch=True)
    feats = precompute_pooled_features(model, rows, batch_size=2, verbose=False)
    assert [f.shape[0] for f in feats] == [5] * 4
    want = automoe_pooled_features(model, {"image": torch.from_numpy(rows.images)})
    for f, w in zip(feats, want):
        np.testing.assert_allclose(f, w.numpy(), rtol=1e-5, atol=1e-6)
    again = precompute_pooled_features(model, batched, batch_size=2, verbose=False)
    for f, g in zip(feats, again):
        np.testing.assert_array_equal(f, g)

    ds = PooledFeatureDataset(batched, feats)
    b = ds.read_batch([4, 1])
    np.testing.assert_array_equal(b["image"], batched.images[[4, 1]])
    for i, f in enumerate(feats):
        np.testing.assert_array_equal(b[f"expert_pooled_{i}"], f[[4, 1]])
        np.testing.assert_array_equal(ds[3][f"expert_pooled_{i}"], f[3])
    assert ds[3]["meta"] == {"i": 3} and len(ds) == 5
    assert not hasattr(PooledFeatureDataset(rows, feats), "read_batch")
    with pytest.raises(ValueError, match="feature cache rows"):
        PooledFeatureDataset(_Rows(4), feats)


def test_fingerprint_and_cache_dir(jax_ee, tmp_path, monkeypatch, capsys):
    from automoe_tpu_torch.train import feature_cache as fc

    _, model = _port_model(jax_ee["init"])
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fp = fc.cache_fingerprint(sd, 10, "root:train")
    assert fp == fc.cache_fingerprint(model.state_dict(), 10, "root:train")
    assert fp != fc.cache_fingerprint(sd, 11, "root:train")
    assert fp != fc.cache_fingerprint(sd, 10, "root:val")
    name = next(k for k in sd if k.startswith("experts.1.") and k.endswith("running_var"))
    assert fp != fc.cache_fingerprint({**sd, name: sd[name] * 1.001}, 10, "root:train")
    head = next(k for k in sd if k.startswith("gating_network."))
    assert fp == fc.cache_fingerprint({**sd, head: sd[head] + 1}, 10, "root:train")

    class Loader:
        def __init__(self):
            self.dataset = _Rows(3, batch=True)

    first, second = Loader(), Loader()
    fc.attach_pooled_features(model, first, None, batch_size=2, cache_dir=str(tmp_path),
                              cache_tags=["r:train", "r:val"])
    files = list(tmp_path.glob("pooled_*.npz"))
    assert len(files) == 1 and not list(tmp_path.glob("*.tmp*"))
    monkeypatch.setattr(fc, "precompute_pooled_features",
                        lambda *a, **k: pytest.fail("the cache was computed again"))
    capsys.readouterr()
    fc.attach_pooled_features(model, second, batch_size=2, cache_dir=str(tmp_path),
                              cache_tags=["r:train"])
    assert "[feature-cache] loaded" in capsys.readouterr().out
    for a, b in zip(first.dataset.feats, second.dataset.feats):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--cache-expert-features", "--unfreeze-experts"],
    ["--device-resident"],
    ["--device-resident", "--cache-expert-features", "--grad-accum", "2"],
], ids=["cache-unfrozen", "resident-without-cache", "resident-grad-accum"])
def test_gating_cli_guards(flags, tmp_path):
    from automoe_tpu_torch.train.cli import main

    with pytest.raises(SystemExit) as e:
        main(["gating", "--data-root", str(tmp_path), "--device", "cpu", *flags])
    assert "--" in str(e.value.code)


@pytest.fixture(scope="module")
def packed_seq(module_tmp):
    from automoe_tpu_torch.data.pack_cli import main as pack
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    base = module_tmp("seq")
    seq = synth_carla_sequence(base / "seq", n_per_split={"train": 24, "val": 16}, size=S,
                               seed=4)
    pack(["carla-sequences", "--root", str(seq), "--out", str(base / "packed"),
          "--horizon", str(H)])
    return base / "packed"


@pytest.mark.parametrize("resident", [False, True], ids=["host", "device-resident"])
def test_gating_cli_cached(packed_seq, resident, tmp_path, capsys):
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.train.cli import main
    from automoe_tpu_torch.train.workloads import gating_workload

    argv = ["gating", "--packed-root", str(packed_seq), "--image-size", str(S),
            "--batch-size", "4", "--epochs", "2", "--device", "cpu", "--num-workers", "1",
            "--model-config", json.dumps(MODEL_CFG), "--cache-expert-features",
            "--feature-cache-dir", str(tmp_path / "fc"), "--ckpt-root", str(tmp_path / "ck"),
            "--runs-root", str(tmp_path / "runs")]
    if resident:
        argv += ["--device-resident", "--steps-per-call", "2"]
    res = main(argv)
    out = capsys.readouterr().out
    assert np.isfinite(res["best_val_loss"]) and "[feature-cache] saved" in out
    assert ("[device-resident] staged 16/16 samples" in out) == resident
    last = load_checkpoint(tmp_path / "ck" / "gating" / "run" / "last.pt")
    init = gating_workload(MODEL_CFG).init_model(0, "cpu").state_dict()
    assert sorted(last["model_state_dict"]) == sorted(init)
    for k, v in init.items():  # the experts' weights and statistics, untouched
        if k.startswith("experts."):
            assert torch.equal(last["model_state_dict"][k], v), k
    assert last["step"] == 2 * 4  # 16 windows at batch 4, two epochs
    main(argv + ["--run-name", "again"])
    assert capsys.readouterr().out.count("[feature-cache] loaded") == 2
