"""The port's policy and gating pipelines against the JAX package on the
CPU, on the same numpy inputs and weights:

* `world_to_ego_xy` and `CarlaSequenceDataset` / its loader on the same
  `.pt` frames: exact;
* `policy_losses` and `gating_losses` under several loss configs: rtol 1e-5;
* the controls: read only when all four of speed, steering, throttle and
  brake are present, as the JAX model reads them (eval-mode forward,
  rtol 1e-4 / atol 1e-5);
* one gating train step over a small AutoMoE (JAX at `highest`
  precision, dropout off on both sides, BatchNorm in train mode): loss and
  BatchNorm running-stat updates rtol 1e-4 / atol 1e-6, trainable
  gradients rtol 1e-4 / atol 1e-5 (the smallest entries of a gradient
  whose largest is ~0.2 carry ~3e-6 of float32 rounding; the conv biases
  ahead of train-mode BatchNorm have a true gradient of 0 and hold ~1e-8
  of noise on both sides);
* a 3-step SGD gating trajectory (the experts' parameters stay those
  grafted, their running statistics move as in JAX) and a 3-step SGD
  policy trajectory: parameters rtol 1e-3 / atol 1e-5 (SGD: AdamW turns
  those 1e-8 noise gradients into ±lr steps of random sign);
* `automoe_eval_batch` and `context_gating_correlation`: rtol 1e-5;
  `evaluate_automoe`, whose eval-mode forward runs four float32 trunks:
  rtol 1e-4 / atol 1e-5;
* `load_expert_checkpoints`: the JAX graft of a port-written detection
  checkpoint and a reference-named nuScenes `.pth`, carried across with
  `state_dict_from_jax`, equals the port's graft of the same files;
* the CLI chain on the CPU: finetune-carla → gating --expert-ckpts →
  automoe-serve-torch --checkpoint, and policy's --epochs 0 dry run.
The JAX step is compiled once per module."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
# 64 px: at 32 px the trunks' last BatchNorm normalises 2 values (1x1 maps,
# B=2), where JAX's E[x²]−E[x]² variance turns rounding into ~1e-3
# relative output differences, more than the tolerances below
S, H, B, N_STEPS, CTX = 64, 4, 2, 3, 8
LR = 1e-2
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
LOSS_CONFIGS = [
    {},
    LCFG,
    {"use_load_balancing": False, "entropy_weight": 0.01},
    {"use_entropy_loss": False, "ade_weight": 0.5, "fde_weight": 1.0,
     "smoothness_weight": 0.2},
]


def _seq_batches(seed: int, n: int = N_STEPS):
    rng = np.random.default_rng(seed)
    return [{
        "image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
        "speed": rng.uniform(0, 30, (B, H)).astype(np.float32),
        "steering": (rng.normal(size=(B, H)) * 0.2).astype(np.float32),
        "throttle": rng.uniform(0, 1, (B, H)).astype(np.float32),
        "brake": (rng.uniform(0, 1, (B, H)) < 0.2).astype(np.float32),
        "waypoints": (rng.normal(size=(B, H, 2)) * 3).astype(np.float32),
        "context": rng.uniform(0, 1, (B, CTX)).astype(np.float32),
    } for _ in range(n)]


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}


def _no_dropout(model):
    """Dropout off in the port (the test's counterpart of JAX's
    deterministic=True): p=0 stays off through model.train()."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_world_to_ego_matches_jax():
    from automoe_tpu.data.ego import world_to_ego_xy as jax_ego

    from automoe_tpu_torch.data.ego import world_to_ego_xy

    rng = np.random.default_rng(0)
    for _ in range(5):
        pts, origin = rng.normal(size=(7, 2)) * 50, rng.normal(size=2) * 50
        yaw = float(rng.uniform(-360, 360))
        np.testing.assert_array_equal(world_to_ego_xy(pts, origin, yaw),
                                      jax_ego(pts, origin, yaw))


@pytest.fixture(scope="module")
def seq_root(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    return synth_carla_sequence(module_tmp("seq"),
                                n_per_split={"train": 24, "val": 16}, size=S, seed=4)


@pytest.mark.parametrize("include_context,stride", [(True, 1), (False, 3)])
def test_sequence_dataset_matches_jax(seq_root, include_context, stride):
    from automoe_tpu.data.datasets import CarlaSequenceDataset as JaxDataset

    from automoe_tpu_torch.data.datasets import CarlaSequenceDataset

    kw = dict(horizon=H, stride=stride, include_context=include_context)
    mine, ref = CarlaSequenceDataset(seq_root / "train", **kw), JaxDataset(seq_root / "train", **kw)
    assert len(mine) == len(ref) > 0 and mine.index == ref.index
    for i in range(len(ref)):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b) and ("context" in a) == include_context
        for k in b:
            if k == "meta":
                assert a[k] == b[k]
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sequence_loader_matches_jax(seq_root):
    from automoe_tpu.data.factories import get_carla_sequence_loader as jax_loader

    from automoe_tpu_torch.data import get_carla_sequence_loader

    for split in ("train", "val"):
        kw = dict(split=split, batch_size=3, num_workers=2, root_dir=str(seq_root), horizon=H)
        mine, ref = get_carla_sequence_loader(**kw), jax_loader(**kw)
        assert len(mine) == len(ref)
        mine.set_epoch(1)
        ref.set_epoch(1)
        got, want = list(mine), list(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in b:
                if k != "meta":
                    np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _pred(rng, horizon_seq=H):
    w = rng.uniform(0.01, 1, (B, 4))
    return {
        "waypoints": rng.normal(size=(B, H, 2)).astype(np.float32),
        "speed": rng.normal(size=(B, 1)).astype(np.float32),
        "speed_seq": rng.normal(size=(B, horizon_seq)).astype(np.float32),
        "expert_weights": (w / w.sum(-1, keepdims=True)).astype(np.float32),
        "gate_logits": rng.normal(size=(B, 4)).astype(np.float32),
    }


@pytest.mark.parametrize("horizon_seq", [H, H + 2], ids=["profile", "last-step"])
@pytest.mark.parametrize("cfg", range(len(LOSS_CONFIGS)))
def test_gating_losses_match_jax(cfg, horizon_seq):
    import jax.numpy as jnp
    from automoe_tpu.losses import gating_losses as jax_losses

    from automoe_tpu_torch.losses import gating_losses

    rng = np.random.default_rng(cfg)
    pred = _pred(rng, horizon_seq)
    wp, spd = rng.normal(size=(B, H, 2)).astype(np.float32), rng.normal(size=(B, H)).astype(
        np.float32)
    want = jax_losses({k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(wp),
                      jnp.asarray(spd), LOSS_CONFIGS[cfg])
    got = gating_losses(_tb(pred), torch.from_numpy(wp), torch.from_numpy(spd),
                        LOSS_CONFIGS[cfg])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_policy_losses_match_jax():
    import jax.numpy as jnp
    from automoe_tpu.losses import policy_losses as jax_losses

    from automoe_tpu_torch.losses import policy_losses

    rng = np.random.default_rng(9)
    pred = {"waypoints": rng.normal(size=(B, H, 2)).astype(np.float32),
            "speed": rng.normal(size=(B, H)).astype(np.float32)}
    wp, spd = rng.normal(size=(B, H, 2)).astype(np.float32), rng.normal(size=(B, H)).astype(
        np.float32)
    want = jax_losses({k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(wp),
                      jnp.asarray(spd))
    got = policy_losses(_tb(pred), torch.from_numpy(wp), torch.from_numpy(spd))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_pooled_feature_dim_matches_jax():
    from automoe_tpu.configs import load_model_config as jax_cfg
    from automoe_tpu.train.workloads import pooled_feature_dim as jax_dim

    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.train.workloads import pooled_feature_dim

    for a, b in zip(load_model_config(MODEL_CFG).experts, jax_cfg(MODEL_CFG).experts):
        assert pooled_feature_dim(a) == jax_dim(b)


# ---------------------------------------------------------------------------
# the gating step and trajectory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gating():
    """The JAX gating workload's model from perturbed init weights, one
    jitted value-and-grad in train mode with dropout off, and N_STEPS SGD
    steps of the JAX package's masked optimizer (experts frozen)."""
    import optax
    from automoe_tpu.losses import gating_losses
    from automoe_tpu.models.automoe import expert_param_mask
    from automoe_tpu.train.state import make_optimizer
    from automoe_tpu.train.workloads import gating_workload

    wl = gating_workload(MODEL_CFG, image_size=S)
    v = jax.device_get(wl.init_variables(jax.random.key(0)))
    rng = np.random.default_rng(21)
    init = {"params": _perturb_norms(v["params"], rng),
            "batch_stats": _perturb_norms(v["batch_stats"], rng)}

    def loss(params, stats, batch):
        out, upd = wl.model.apply({"params": params, "batch_stats": stats}, batch, train=True,
                                  deterministic=True, mutable=["batch_stats"])
        res = gating_losses(out, batch["waypoints"], batch["speed"], LCFG)
        return res["total_loss"], (res, upd["batch_stats"])

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    tx = make_optimizer(learning_rate=LR, weight_decay=0.0, total_steps=N_STEPS,
                        optimizer="sgd", schedule="cosine_per_epoch", steps_per_epoch=N_STEPS,
                        trainable_mask=expert_param_mask(init["params"]))
    update = jax.jit(tx.update)
    params, stats = init["params"], init["batch_stats"]
    opt_state = tx.init(params)
    losses, first = [], None
    for batch in _seq_batches(5):
        (lv, (res, new_stats)), grads = vg(params, stats, batch)
        if first is None:
            first = {"res": jax.device_get(res), "grads": jax.device_get(grads),
                     "stats": jax.device_get(new_stats)}
        upd, opt_state = update(grads, opt_state, params)
        params, stats = optax.apply_updates(params, upd), new_stats
        losses.append(float(lv))
    return {"model": wl.model, "init": init, "first": first, "losses": losses,
            "final": {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}}


def _port_gating_model(init):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.train.workloads import gating_workload

    wl = gating_workload(MODEL_CFG, loss_config=LCFG)
    model = wl.init_model(0, "cpu")
    model.load_state_dict(state_dict_from_jax(init, MODEL_CFG), strict=True)
    return wl, _no_dropout(model)


def test_gating_step_matches_jax(jax_gating):
    from automoe_tpu_torch.ckpt import state_dict_from_jax

    wl, model = _port_gating_model(jax_gating["init"])
    batch = _tb(_seq_batches(5)[0])
    model.train()
    loss, metrics = wl.loss_fn(model, batch, True)
    loss.backward()
    res = jax_gating["first"]["res"]
    np.testing.assert_allclose(float(loss.detach()), float(res["total_loss"]), rtol=1e-4,
                               atol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(res[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want_g = state_dict_from_jax({"params": jax_gating["first"]["grads"]}, MODEL_CFG)
    n = 0
    for name, p in model.named_parameters():
        if name.startswith("experts."):
            assert p.grad is None and not p.requires_grad, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        n += 1
    assert n > 0
    want_s = state_dict_from_jax({"params": jax_gating["init"]["params"],
                                  "batch_stats": jax_gating["first"]["stats"]}, MODEL_CFG)
    for name, t in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want_s[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_controls_are_read_as_jax_reads_them(jax_gating):
    """With speed and steering but no throttle/brake, the JAX model feeds
    zeros for all three controls (it reads them only when all four keys
    are present); the port's eval-mode forward matches it."""
    batch = {k: v for k, v in _seq_batches(9, 1)[0].items()
             if k in ("image", "speed", "steering")}
    want = jax_gating["model"].apply(jax_gating["init"], batch)
    _, port = _port_gating_model(jax_gating["init"])
    with torch.no_grad():
        got = port.eval()(_tb(batch))
        zero_ctl = port.eval()(_tb({**batch, "steering": np.zeros_like(batch["steering"])}))
    for k in ("context_features", "expert_weights", "waypoints"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        assert torch.equal(got[k], zero_ctl[k]), k


@pytest.fixture(scope="module")
def port_gating_run(jax_gating, module_tmp):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import gating_workload

    tmp = module_tmp("gating")
    batches = _seq_batches(5)
    tr = Trainer(gating_workload(MODEL_CFG, loss_config=LCFG), batches, batches, TrainConfig(
        epochs=1, learning_rate=LR, weight_decay=0.0, optimizer="sgd",
        schedule="cosine_per_epoch", run_name="p", ckpt_root=str(tmp / "ckpt"),
        runs_root=str(tmp / "runs"), device="cpu", log_every=1))
    tr.model.load_state_dict(state_dict_from_jax(jax_gating["init"], MODEL_CFG), strict=True)
    _no_dropout(tr.model)
    tr.train_epoch(0)
    tr.logger.close()
    recs = map(json.loads, (tmp / "runs" / "gating_p" / "metrics.jsonl").read_text().splitlines())
    return {"losses": [r["train/loss"] for r in recs if "train/loss" in r],
            "final": {k: v.detach() for k, v in tr.model.state_dict().items()}}


def test_gating_trajectory_losses_match_jax(jax_gating, port_gating_run):
    assert len(port_gating_run["losses"]) == N_STEPS
    np.testing.assert_allclose(port_gating_run["losses"], jax_gating["losses"], rtol=1e-4)


@pytest.mark.parametrize("group", ["expert_extractors.", "context_extractor.",
                                   "gating_network.", "policy_head.", "experts."])
def test_gating_trajectory_state_matches_jax(jax_gating, port_gating_run, group):
    """After N_STEPS: every tensor of the group within rtol 1e-3 / atol
    1e-5 of JAX's. The experts' parameters are exactly the initial ones
    (frozen), while their BatchNorm running statistics have moved."""
    from automoe_tpu_torch.ckpt import state_dict_from_jax

    want = state_dict_from_jax(jax_gating["final"], MODEL_CFG)
    init = state_dict_from_jax(jax_gating["init"], MODEL_CFG)
    got = port_gating_run["final"]
    keys = [k for k in got if k.startswith(group) and not k.endswith("num_batches_tracked")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
        if group == "experts.":
            frozen = not k.endswith(("running_mean", "running_var"))
            assert torch.equal(got[k], init[k]) == frozen, k


@pytest.mark.parametrize("group", ["backbone.", "head_wp.", "head_spd."])
def test_policy_trajectory_matches_jax(group, tmp_path):
    """N_STEPS SGD steps of the policy workload (constant schedule,
    context_dim 8) in both packages from the same weights."""
    from automoe_tpu.train.loop import TrainConfig as JaxConfig
    from automoe_tpu.train.loop import Trainer as JaxTrainer
    from automoe_tpu.train.state import TrainState
    from automoe_tpu.train.workloads import policy_workload as jax_workload

    from automoe_tpu_torch.ckpt import policy_state_dict_from_jax
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import policy_workload

    batches = _seq_batches(6)
    kw = dict(epochs=1, learning_rate=LR, weight_decay=0.0, optimizer="sgd", schedule="constant",
              runs_root=str(tmp_path / "runs"), ckpt_root=str(tmp_path / "ckpt"))
    jtr = JaxTrainer(jax_workload(horizon=H, context_dim=CTX, image_size=S), batches, batches,
                     JaxConfig(run_name="j", log_every=1, max_inflight=0, **kw))
    rng = np.random.default_rng(8)
    init = {"params": _perturb_norms(jax.device_get(jtr.state.params), rng),
            "batch_stats": _perturb_norms(jax.device_get(jtr.state.batch_stats), rng)}
    jtr.state = TrainState.create(params=init["params"], tx=jtr.state.tx,
                                  batch_stats=init["batch_stats"])
    jtr.train_epoch(0)
    jtr.logger.close()
    want = policy_state_dict_from_jax({"params": jax.device_get(jtr.state.params),
                                       "batch_stats": jax.device_get(jtr.state.batch_stats)})

    ptr = Trainer(policy_workload(horizon=H, context_dim=CTX), batches, batches,
                  TrainConfig(run_name="p", device="cpu", log_every=1, **kw))
    ptr.model.load_state_dict(policy_state_dict_from_jax(init), strict=True)
    ptr.train_epoch(0)
    ptr.logger.close()
    got = ptr.model.state_dict()
    keys = [k for k in want if k.startswith(group) and not k.endswith("num_batches_tracked")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("horizon_seq", [H, H + 1], ids=["profile", "last-step"])
def test_eval_batch_matches_jax(horizon_seq):
    import jax.numpy as jnp
    from automoe_tpu.evals.gating import automoe_eval_batch as jax_eval

    from automoe_tpu_torch.evals.gating import automoe_eval_batch

    rng = np.random.default_rng(horizon_seq)
    pred = _pred(rng, horizon_seq)
    wp, spd = rng.normal(size=(B, H, 2)).astype(np.float32), rng.normal(size=(B, H)).astype(
        np.float32)
    want = jax_eval({k: jnp.asarray(v) for k, v in pred.items()}, jnp.asarray(wp),
                    jnp.asarray(spd))
    got = automoe_eval_batch(_tb(pred), torch.from_numpy(wp), torch.from_numpy(spd))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_evaluate_automoe_matches_jax(jax_gating):
    """Eval-mode forward over two batches, the second a repeat-padded tail
    with one real row."""
    from automoe_tpu.evals.gating import evaluate_automoe as jax_evaluate

    from automoe_tpu_torch.evals.gating import evaluate_automoe

    batches = _seq_batches(7, 2)
    batches[1] = {k: np.concatenate([v[:1], v[:1]]) for k, v in batches[1].items()}
    batches[1]["_real_count"] = 1
    model = jax_gating["model"]
    want = jax_evaluate(lambda v, b: model.apply(v, b), jax_gating["init"], batches)
    _, port = _port_gating_model(jax_gating["init"])
    got = evaluate_automoe(port, batches)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(v, np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("use_logits", [False, True])
def test_context_gating_correlation_matches_jax(use_logits):
    from automoe_tpu.evals.gating import context_gating_correlation as jax_corr

    from automoe_tpu_torch.evals.gating import context_gating_correlation

    rng = np.random.default_rng(3)
    ctx = rng.normal(size=(40, 4))
    ctx[:, 2] = 1.0  # a constant column is dropped
    w = rng.uniform(0.01, 1, (40, 4))
    w /= w.sum(-1, keepdims=True)
    kw = dict(use_logits=use_logits, context_names=["speed", "steer"])
    gating = np.log(w) if use_logits else w
    want, got = jax_corr(ctx, gating, **kw), context_gating_correlation(ctx, gating, **kw)
    assert got["context_names"] == want["context_names"]
    assert got["expert_names"] == want["expert_names"]
    for k in ("pearson", "spearman"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# expert handoff
# ---------------------------------------------------------------------------

def _expert_files(tmp_path):
    """A port-written detection checkpoint (CheckpointManager) and a
    reference-named nuScenes `.pth` (mlp.* / box_head.*), seeded."""
    from automoe_tpu_torch.ckpt import CheckpointManager
    from automoe_tpu_torch.models.automoe import init_parameters
    from automoe_tpu_torch.models.experts import BDDDetectionExpert, NuScenesExpert
    from automoe_tpu_torch.train.state import make_optimizer

    det = BDDDetectionExpert(10)
    init_parameters(det, torch.Generator().manual_seed(31))
    with torch.no_grad():
        for name, t in det.named_buffers():
            if name.endswith("running_mean"):
                t.uniform_(-0.2, 0.2)
    mgr = CheckpointManager(str(tmp_path), "bdd_detection", "e")
    mgr.save_epoch(det, make_optimizer(det.named_parameters(), learning_rate=1e-3,
                                       total_steps=1), 0, 1.0)
    nus = NuScenesExpert(num_queries=8, bbox_dim=4, num_classes=10, fusion="sum")
    init_parameters(nus, torch.Generator().manual_seed(32))
    sd = {k.replace("decoder.", "mlp.", 1).replace("bbox_head.", "box_head.", 1): v
          for k, v in nus.state_dict().items()}
    pth = tmp_path / "nuscenes.pth"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in sd.items()}}, pth)
    return mgr.path("best"), pth


def test_load_expert_checkpoints_matches_jax(jax_gating, tmp_path):
    from automoe_tpu.ckpt.compose import load_expert_checkpoints as jax_graft
    from automoe_tpu.configs import load_model_config as jax_cfg

    from automoe_tpu_torch.ckpt import load_expert_checkpoints, state_dict_from_jax
    from automoe_tpu_torch.configs import load_model_config

    det, nus = _expert_files(tmp_path)
    paths = [str(det), "", "", str(nus)]
    grafted = jax_graft(jax_gating["init"], jax_cfg(MODEL_CFG), paths)
    want = state_dict_from_jax(jax.device_get(grafted), MODEL_CFG)
    _, port = _port_gating_model(jax_gating["init"])
    load_expert_checkpoints(port, load_model_config(MODEL_CFG), paths)
    got = port.state_dict()
    init = state_dict_from_jax(jax_gating["init"], MODEL_CFG)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=0, err_msg=k)
        assert torch.equal(got[k], init[k]) == (not k.startswith(("experts.0.", "experts.3."))), k


def test_load_expert_checkpoints_raises_on_a_missing_key(tmp_path):
    from automoe_tpu_torch.ckpt import load_expert_checkpoints
    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.train.workloads import gating_workload

    det, _ = _expert_files(tmp_path)
    payload = torch.load(det, weights_only=True)
    del payload["model_state_dict"]["head.2.bias"]
    torch.save(payload, tmp_path / "cut.pt")
    model = gating_workload(MODEL_CFG).init_model(0, "cpu")
    cfg = load_model_config(MODEL_CFG)
    with pytest.raises(KeyError, match="head.2.bias"):
        load_expert_checkpoints(model, cfg, [str(tmp_path / "cut.pt"), "", "", ""])
    with pytest.raises(ValueError, match="expected 4"):
        load_expert_checkpoints(model, cfg, [str(det)])


# ---------------------------------------------------------------------------
# the CLI chain
# ---------------------------------------------------------------------------

def test_cli_detection_to_gating_to_server_on_cpu(tmp_path, seq_root):
    """finetune-carla writes a detection expert; gating --expert-ckpts
    grafts it and writes ckpt/gating/<run>/best.pt, whose expert-0
    parameters are the detection checkpoint's (its BatchNorm statistics
    moved: frozen experts run train-mode BatchNorm); automoe-serve-torch
    serves that file, int8, and answers a request."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.serving import Client
    from automoe_tpu_torch.serving.cli import main as serve_main
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import main

    det_root = synth_carla_detection(tmp_path / "det", n_per_split={"train": 4, "val": 2},
                                     size=S, max_boxes=3)
    common = ["--ckpt-root", str(tmp_path / "ckpt"), "--runs-root", str(tmp_path / "runs"),
              "--image-size", str(S), "--num-workers", "1", "--device", "cpu"]
    main(["finetune-carla", "--task", "detection", "--data-root", str(det_root),
          "--box-cap", "4", "--batch-size", "2", "--epochs", "1", "--run-name", "det", *common])
    det_ckpt = tmp_path / "ckpt" / "bdd_detection" / "det" / "best.pt"
    res = main(["gating", "--data-root", str(seq_root), "--batch-size", "2", "--epochs", "1",
                "--model-config", json.dumps(MODEL_CFG), "--expert-ckpts", f"{det_ckpt},,,",
                "--run-name", "g", *common])
    assert np.isfinite(res["best_val_loss"])
    gating_best = tmp_path / "ckpt" / "gating" / "g" / "best.pt"
    det_sd = load_checkpoint(det_ckpt)["model_state_dict"]
    g = load_checkpoint(gating_best)
    assert g["epoch"] == 0 and g["step"] == g["optimizer"]["count"] > 0
    moved = 0
    for k, v in det_sd.items():
        got = g["model_state_dict"][f"experts.0.{k}"]
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            moved += not torch.equal(got, v)
        else:
            assert torch.equal(got, v), k
    assert moved > 0
    assert json.loads((gating_best.parent / "config.json").read_text())["cmd"] == "gating"

    srv, batcher = serve_main(["--device", "cpu", "--checkpoint", str(gating_best), "--quantize",
                               "--model-config", json.dumps(MODEL_CFG), "--port", "0",
                               "--camera-hw", "96", "128", "--model-hw", "64", "64",
                               "--max-wait-ms", "1"], block=False)
    try:
        c = Client(*srv.server_address[:2])
        ans = c.infer(np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8),
                      12.0)
        c.close()
    finally:
        srv.shutdown()
        batcher.close()
    assert ans["waypoints"].shape == (H, 2) and np.isfinite(ans["waypoints"]).all()
    np.testing.assert_allclose(ans["expert_weights"].sum(), 1.0, rtol=1e-2)  # bf16 engine


def test_cli_policy_dry_run_and_training(tmp_path, seq_root, capsys):
    from automoe_tpu_torch.train.cli import main

    assert main(["policy", "--device", "cpu", "--image-size", str(S), "--horizon", "5"]) == {
        "dry_run": True}
    assert "'waypoints': (2, 5, 2), 'speed': (2, 5)" in capsys.readouterr().out
    res = main(["policy", "--data-root", str(seq_root), "--image-size", str(S), "--horizon",
                str(H), "--context-dim", str(CTX), "--batch-size", "4", "--epochs", "1",
                "--num-workers", "1", "--device", "cpu", "--ckpt-root", str(tmp_path / "ckpt"),
                "--runs-root", str(tmp_path / "runs")])
    assert np.isfinite(res["best_val_loss"])
    assert (tmp_path / "ckpt" / "carla_policy" / "run" / "best.pt").is_file()
