"""The model options a served config reaches, in the PyTorch port against
the JAX package on the CPU, on the same numpy inputs and weights:

* `FullContextExtractor` and the whole AutoMoE forward with `context:
  full` and top-k routing honoured at eval (float32, rtol 1e-3 / atol
  1e-4, as tests/test_torch_port_models.py);
* top-k routing (`honor_topk_in_composite`, `top_k=2`, noise_scale 0) in
  train mode and at eval with `apply_topk_at_eval`, `_topk_mask` on
  logits with ties (exact);
* the routing noise by its statistics (its bits cannot match
  `jax.random`), reproducible under one seed, and a loud error without a
  generator;
* `context_only_weights` / `context_only_logits`,
  `automoe_context_weights` ('simple' and 'full') and `MoEArchitecture`;
* one gating train step with top-k honoured: its loss equals JAX's
  (rtol 1e-4); with noise on, two runs under one seed are identical;
* the int8 forward with trunk "v1" and stems "fused" and "solo" on the
  JAX package's calibration scales (the q8 trunk's tolerances of
  tests/test_torch_port_quant.py).
One JAX AutoMoE (3 experts, full context, top-k honoured) is built per
module; its references run eagerly at 64 px."""
from __future__ import annotations

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms, rel_err
from tests.torch_port_common import module_tmp  # noqa: F401  (removes what tests write)

S, B, H = 64, 2, 4
TOL = dict(rtol=1e-3, atol=1e-4)
CFG = {
    "experts": [
        {"type": "detection", "num_classes": 10},
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 2, "noise_scale": 0.0, "apply_topk_at_eval": True,
               "honor_topk_in_composite": True},
    "context": {"type": "full", "context_dim": 64},
    "policy": {"num_waypoints": H},
}


def _cfg(**gating):
    cfg = copy.deepcopy(CFG)
    cfg["gating"].update(gating)
    return cfg


def _batch(seed: int, b: int = B):
    """A gating batch with every 'full' context entry but `lane_count`
    (its default is 1)."""
    rng = np.random.default_rng(seed)

    def col(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (b, 1)).astype(np.float32)

    return {
        "image": rng.normal(size=(b, S, S, 3)).astype(np.float32),
        "speed": rng.uniform(0, 30, (b, H)).astype(np.float32),
        "steering": (rng.normal(size=(b, H)) * 0.2).astype(np.float32),
        "throttle": rng.uniform(0, 1, (b, H)).astype(np.float32),
        "brake": (rng.uniform(0, 1, (b, H)) < 0.3).astype(np.float32),
        "waypoints": (rng.normal(size=(b, H, 2)) * 3).astype(np.float32),
        "hour": col(0, 24), "minute": col(0, 60),
        "weather": {"rain": col(), "fog": col(), "wetness": col(), "sun_angle": col(-90, 90)},
        "road": {"road_type": col(0, 3), "curvature": col(-0.1, 0.1)},
    }


def _jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch_batch(batch):
    return jax.tree.map(torch.from_numpy, batch)


def _no_dropout(model):
    """Dropout off in the port (the counterpart of JAX's
    deterministic=True): p=0 stays off through model.train()."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def composite():
    """The JAX AutoMoE of CFG (fast gating pool) with perturbed norms, and
    its eval-mode outputs on one batch."""
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.utils import jit_init

    model = create_automoe_model(CFG, fast_gating_pool=True)
    batch = _batch(0)
    v = jax.device_get(jit_init(model, jax.random.key(0), _jax_batch(batch)))
    rng = np.random.default_rng(1)
    variables = {"params": _perturb_norms(v["params"], rng),
                 "batch_stats": _perturb_norms(v["batch_stats"], rng)}
    return model, variables, batch, model.apply(variables, _jax_batch(batch))


def _port_model(variables, cfg=CFG):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.models import create_automoe_model

    model = create_automoe_model(cfg, fast_gating_pool=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include", [(True, True, True), (False, True, False)],
                         ids=["all", "time-only"])
def test_full_context_extractor_matches_jax(include):
    from automoe_tpu.models.context import FullContextExtractor as JaxFull

    from automoe_tpu_torch.models.context import FullContextExtractor

    batch = _batch(3)
    data = {k: batch[k][:, -1:] for k in ("speed", "steering", "brake")}  # no throttle
    data.update({k: batch[k] for k in ("hour", "minute", "weather", "road")})
    jm = JaxFull(32, *include)
    v = jax.device_get(jm.init(jax.random.key(2), _jax_batch(data)))
    p = _perturb_norms(v["params"], np.random.default_rng(3))
    want = jm.apply({"params": p}, _jax_batch(data))

    pm = FullContextExtractor(32, *include)
    pm.load_state_dict({
        "context_encoder.0.weight": torch.from_numpy(p["fc1"]["kernel"].T.copy()),
        "context_encoder.0.bias": torch.from_numpy(p["fc1"]["bias"]),
        "context_encoder.3.weight": torch.from_numpy(p["fc2"]["kernel"].T.copy()),
        "context_encoder.3.bias": torch.from_numpy(p["fc2"]["bias"]),
        "context_encoder.4.weight": torch.from_numpy(p["ln"]["scale"]),
        "context_encoder.4.bias": torch.from_numpy(p["ln"]["bias"]),
    }, strict=True)
    got = pm.eval()(_torch_batch(data))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_automoe_full_context_topk_at_eval_matches_jax(composite):
    _, variables, batch, want = composite
    pm = _port_model(variables)
    with torch.no_grad():
        got = pm(_torch_batch(batch))
    for k in ("waypoints", "speed", "speed_seq", "expert_weights", "context_features",
              "combined_features", "gate_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    w = got["expert_weights"].numpy()
    assert ((w > 0).sum(-1) == 2).all()  # top-2 of 3 experts at eval


# ---------------------------------------------------------------------------
# top-k routing and its noise
# ---------------------------------------------------------------------------

def test_topk_mask_matches_jax_with_ties():
    from automoe_tpu.models.gating import _topk_mask as jax_mask

    from automoe_tpu_torch.models.gating import _topk_mask

    rng = np.random.default_rng(5)
    logits = rng.integers(-2, 3, (64, 6)).astype(np.float32)  # many ties
    for k in (0, 1, 2, 3, 6, 7):
        np.testing.assert_array_equal(_topk_mask(torch.from_numpy(logits), k).numpy(),
                                      np.asarray(jax_mask(jnp.asarray(logits), k)),
                                      err_msg=str(k))


def _gating_pair(cfg, seed: int = 7):
    """(JAX gating network of `cfg`'s composite, its params with perturbed
    norms, the port's network on them, expert features, context)."""
    from automoe_tpu.configs import load_model_config
    from automoe_tpu.models.gating import gating_network_from_config as jax_from_config

    from automoe_tpu_torch.ckpt import gating_state_dict_from_jax
    from automoe_tpu_torch.models.gating import gating_network_from_config

    jcfg = load_model_config(cfg)
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(8, e.output_dim)).astype(np.float32) for e in jcfg.experts]
    ctx = rng.normal(size=(8, jcfg.context.context_dim)).astype(np.float32)
    jg = jax_from_config(jcfg, jnp.float32)
    v = jax.device_get(jg.init({"params": jax.random.key(seed), "gating": jax.random.key(1)},
                               [jnp.asarray(f) for f in feats], jnp.asarray(ctx)))
    params = _perturb_norms(v["params"], rng)
    pg = gating_network_from_config(jcfg, device="cpu")
    pg.load_state_dict(gating_state_dict_from_jax(params, len(jcfg.experts)), strict=True)
    return jg, params, _no_dropout(pg), feats, ctx


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval-apply_topk_at_eval"])
def test_topk_routing_matches_jax(train):
    jg, params, pg, feats, ctx = _gating_pair(CFG)
    assert pg.top_k == 2 and pg.apply_topk_at_eval
    want = jg.apply({"params": params}, [jnp.asarray(f) for f in feats], jnp.asarray(ctx),
                    train=train, deterministic=True)
    pg.train(train)
    got = pg([torch.from_numpy(f) for f in feats], torch.from_numpy(ctx))
    for k in ("combined_output", "expert_weights", "gate_logits"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), **TOL,
                                   err_msg=k)
    assert ((got["expert_weights"] > 0).sum(-1) == 2).all()


def test_gating_from_config_honors_topk_and_force_deterministic():
    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.models.gating import gating_network_from_config

    dropped = gating_network_from_config(load_model_config(_cfg(honor_topk_in_composite=False,
                                                                noise_scale=1.0)))
    assert (dropped.top_k, dropped.noise_scale, dropped.apply_topk_at_eval) == (0, 0.0, False)
    noisy = load_model_config(_cfg(noise_scale=0.5, noise_type="gaussian"))
    g = gating_network_from_config(noisy)
    assert (g.top_k, g.noise_type, g.noise_scale) == (2, "gaussian", 0.5)
    assert gating_network_from_config(noisy, force_deterministic=True).noise_scale == 0.0


@pytest.mark.parametrize("kind", ["gumbel", "gaussian", "none"])
def test_routing_noise_statistics_and_seed(kind):
    from automoe_tpu_torch.models.gating import sample_noise

    scale = 0.7
    draw = [sample_noise(kind, scale, (200_000,), torch.Generator().manual_seed(11))
            for _ in range(2)]
    torch.testing.assert_close(draw[0], draw[1], rtol=0, atol=0)  # one seed, one draw
    other = sample_noise(kind, scale, (200_000,), torch.Generator().manual_seed(12))
    x = draw[0].double()
    if kind == "none":
        assert not x.any() and not other.any()
        return
    assert not torch.equal(draw[0], other)
    mean, var = {"gumbel": (0.5772157 * scale, math.pi ** 2 / 6 * scale ** 2),
                 "gaussian": (0.0, scale ** 2)}[kind]
    # 200k draws: the mean's standard error is ~0.003, the variance's ~0.005
    assert abs(float(x.mean()) - mean) < 0.015, float(x.mean())
    assert abs(float(x.var()) - var) < 0.03 * max(var, 1.0), float(x.var())


def test_noisy_routing_needs_a_generator_and_is_reproducible():
    _, _, pg, feats, ctx = _gating_pair(_cfg(noise_scale=1.0))
    pg.train()
    f, c = [torch.from_numpy(x) for x in feats], torch.from_numpy(ctx)
    with pytest.raises(ValueError, match="generator"):
        pg(f, c)
    runs = [pg(f, c, generator=torch.Generator().manual_seed(s))["expert_weights"]
            for s in (3, 3, 4)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    assert ((runs[0] > 0).sum(-1) == 2).all()
    # noise=False routes as the deterministic top-k (serving)
    pg.eval()
    np.testing.assert_allclose(pg(f, c, noise=False)["expert_weights"].detach().numpy(),
                               pg.train()(f, c, noise=False)["expert_weights"].detach().numpy())


# ---------------------------------------------------------------------------
# analysis paths and the generic wrapper
# ---------------------------------------------------------------------------

def test_context_only_weights_and_logits_match_jax():
    """noise_scale 1 with apply_topk_at_eval: without a generator the
    analysis path routes noise-free (top-2 still applies), as JAX's does
    without a 'gating' stream."""
    jg, params, pg, _, ctx = _gating_pair(_cfg(noise_scale=1.0), seed=9)
    pg.eval()
    for method in ("context_only_weights", "context_only_logits"):
        want = jg.apply({"params": params}, jnp.asarray(ctx), method=method)
        got = getattr(pg, method)(torch.from_numpy(ctx))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL,
                                   err_msg=method)
    w = pg.context_only_weights(torch.from_numpy(ctx))
    assert ((w > 0).sum(-1) == 2).all()
    noisy = [pg.context_only_weights(torch.from_numpy(ctx),
                                     generator=torch.Generator().manual_seed(s))
             for s in (1, 2)]
    assert not torch.equal(noisy[0], noisy[1])


@pytest.mark.parametrize("context", ["simple", "full"])
def test_automoe_context_weights_matches_jax(composite, context):
    from automoe_tpu.configs import load_model_config
    from automoe_tpu.models.automoe import automoe_context_weights as jax_weights
    from automoe_tpu.models.context import make_context_extractor as jax_ctx

    from automoe_tpu_torch.models.automoe import automoe_context_weights

    jmodel, variables, batch, _ = composite
    cfg = _cfg(noise_scale=1.0)
    cfg["context"]["type"] = context
    jcfg = load_model_config(cfg)
    params = dict(variables["params"])
    if context == "simple":  # a simple extractor's weights in place of the full one's
        rng = np.random.default_rng(13)
        cols = [jnp.zeros((B, 1))] * 4
        v = jax.device_get(jax_ctx(jcfg.context).init(jax.random.key(4), *cols))
        params["context_extractor"] = _perturb_norms(v["params"], rng)
    jmodel = jmodel.clone(config=jcfg)
    jvars = {"params": params, "batch_stats": variables["batch_stats"]}
    want = jax_weights(jmodel, jvars, _jax_batch(batch))
    pm = _port_model(jvars, cfg).train()  # runs in eval mode whatever the model's mode
    got = automoe_context_weights(pm, _torch_batch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ((got > 0).sum(-1) == 2).all() and pm.training


def test_moe_architecture_matches_jax():
    import flax.linen as fnn

    from automoe_tpu.models.gating import GatingNetwork as JaxGating
    from automoe_tpu.models.gating import MoEArchitecture as JaxMoE

    from automoe_tpu_torch.ckpt import gating_state_dict_from_jax
    from automoe_tpu_torch.models.gating import GatingNetwork, MoEArchitecture

    class TinyExpert(fnn.Module):
        @fnn.compact
        def __call__(self, inputs):
            return fnn.Dense(256)(inputs["x"])

    rng = np.random.default_rng(15)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    ctx = rng.normal(size=(4, 64)).astype(np.float32)
    jm = JaxMoE(experts=[TinyExpert(), TinyExpert(), TinyExpert()],
                gating_network=JaxGating(num_experts=3, top_k=2, noise_scale=0.0,
                                         apply_topk_at_eval=True),
                policy_head=fnn.Dense(8))
    v = jax.device_get(jm.init(jax.random.key(5), {"x": jnp.asarray(x)}, jnp.asarray(ctx)))
    p = _perturb_norms(v["params"], rng)
    want = jm.apply({"params": p}, {"x": jnp.asarray(x)}, jnp.asarray(ctx))

    class PortExpert(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(16, 256)

        def forward(self, inputs):
            return self.fc(inputs["x"])

    def linear(tree):
        return {"weight": torch.from_numpy(tree["kernel"].T.copy()),
                "bias": torch.from_numpy(tree["bias"])}

    pm = MoEArchitecture([PortExpert() for _ in range(3)],
                         GatingNetwork(3, top_k=2, noise_scale=0.0, apply_topk_at_eval=True),
                         torch.nn.Linear(256, 8))
    for i in range(3):  # flax names the experts by their attribute
        pm.experts[i].fc.load_state_dict(linear(p[f"experts_{i}"]["Dense_0"]))
    pm.gating_network.load_state_dict(gating_state_dict_from_jax(p["gating_network"], 3))
    pm.policy_head.load_state_dict(linear(p["policy_head"]))
    got = pm.eval()({"x": torch.from_numpy(x)}, torch.from_numpy(ctx))
    for k in ("policy_output", "expert_weights", "combined_features"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), **TOL,
                                   err_msg=k)
    assert len(got["expert_outputs"]) == 3


# ---------------------------------------------------------------------------
# the gating trainer with top-k honoured
# ---------------------------------------------------------------------------

def test_gating_step_loss_with_topk_matches_jax(composite):
    """One train-mode loss (experts in eval mode, dropout off on both
    sides, noise_scale 0) of the gating workload."""
    from automoe_tpu.losses import gating_losses
    from automoe_tpu.models import create_automoe_model as jax_create

    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.train.workloads import gating_workload

    _, variables, _, _ = composite
    batch = _batch(17)
    jm = jax_create(CFG)
    out, _ = jm.apply(variables, _jax_batch(batch), train=True, deterministic=True,
                      experts_eval=True, mutable=["batch_stats"])
    want = gating_losses(out, jnp.asarray(batch["waypoints"]), jnp.asarray(batch["speed"]), {})

    wl = gating_workload(CFG, experts_eval=True)
    model = _no_dropout(wl.init_model(0, "cpu"))
    model.load_state_dict(state_dict_from_jax(variables, CFG), strict=True)
    loss, metrics = wl.loss_fn(model.train(), _torch_batch(batch), True, (1, 0))
    np.testing.assert_allclose(float(loss.detach()), float(want["total_loss"]), rtol=1e-4)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_noisy_gating_training_is_reproducible(module_tmp):
    """Two runs of the gating trainer under one seed, routing noise on,
    end with identical weights; a train step without a key raises."""
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import gating_workload

    # without apply_topk_at_eval: validation draws no noise (a JAX eval
    # step has no 'gating' stream either, and raises with it)
    cfg = _cfg(noise_scale=1.0, apply_topk_at_eval=False)
    batches = [{k: v for k, v in _batch(s).items() if k not in ("weather", "road")}
               for s in (21, 22)]
    finals = []
    for run in ("a", "b"):
        tmp = module_tmp(f"noisy_{run}")
        tr = Trainer(gating_workload(cfg), batches, batches[:1], TrainConfig(
            epochs=1, learning_rate=1e-2, weight_decay=0.0, optimizer="sgd", seed=3,
            run_name=run, ckpt_root=str(tmp / "ckpt"), runs_root=str(tmp / "runs"),
            device="cpu", log_every=1))
        tr.fit()
        finals.append({k: v.clone() for k, v in tr.model.state_dict().items()})
    for k in finals[0]:
        torch.testing.assert_close(finals[0][k], finals[1][k], rtol=0, atol=0, msg=k)
    wl = gating_workload(cfg)
    model = wl.init_model(0, "cpu")
    with pytest.raises(ValueError, match="generator"):
        wl.loss_fn(model, _torch_batch(batches[0]), True)


# ---------------------------------------------------------------------------
# int8: trunk "v1", stems "fused" and "solo"
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_qpack(composite):
    from automoe_tpu.serving import quant as jq

    _, variables, _, _ = composite
    calib = np.random.default_rng(23).normal(size=(B, S, S, 3)).astype(np.float32)
    return jq.quantize_automoe(variables, CFG, [{"image": jnp.asarray(calib)}],
                               dtype=jnp.float32)


def _port_qpack(jpack):
    """The JAX pack in the port's layout (OIHW weights)."""
    def oihw(tree):
        return {k: (np.ascontiguousarray(v.transpose(3, 2, 0, 1)) if k in ("w", "wq") else v)
                for k, v in tree.items()}

    return {"experts": [{n: oihw(p) for n, p in q.items()} for q in jpack["experts"]],
            "scales": jpack["scales"]}


@pytest.mark.parametrize("expert", [0, 2])
def test_v1_trunk_matches_jax(jax_qpack, expert):
    from automoe_tpu.serving import quant as jq

    from automoe_tpu_torch.serving.quant import prepare_qexpert, resnet_quant_forward

    x = np.random.default_rng(25).normal(size=(B, S, S, 3)).astype(np.float32)
    q, scales = jax_qpack["experts"][expert], jax_qpack["scales"][expert]
    want = np.asarray(jq.resnet_quant_forward(q, scales, jnp.asarray(x), dtype=jnp.float32))
    qe = prepare_qexpert(_port_qpack(jax_qpack)["experts"][expert], scales, torch.float32,
                         "cpu", trunk="v1")
    got = resnet_quant_forward(qe, torch.from_numpy(x).permute(0, 3, 1, 2),
                               torch.float32).numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.999, 1.0 - close.mean()


@pytest.mark.parametrize("trunk,stem", [("v1", "s2d"), ("q8", "fused"), ("q8", "solo")])
def test_quant_forward_trunks_and_stems_match_jax(composite, jax_qpack, trunk, stem):
    """make_quant_forward with `trunk` and `stem` against JAX's, full
    context and top-k at eval included (rel. waypoint error < 1e-3,
    expert weights within 1e-3, as test_torch_port_quant.py)."""
    from automoe_tpu.serving import quant as jq

    from automoe_tpu_torch.serving.quant import make_quant_forward, prepare_qexperts

    _, variables, _, _ = composite
    batch = _batch(27)
    want = jq.make_quant_forward(CFG, jax_qpack["scales"], dtype=jnp.float32, trunk=trunk,
                                 stem=stem)(variables, jax_qpack["experts"], _jax_batch(batch))
    pack = _port_qpack(jax_qpack)
    fwd = make_quant_forward(CFG, pack["scales"], dtype=torch.float32, trunk=trunk, stem=stem)
    got = fwd(_port_model(variables),
              prepare_qexperts(pack, torch.float32, "cpu", trunk=trunk, stem=stem),
              _torch_batch(batch))
    assert rel_err(want["waypoints"], got["waypoints"].numpy()) < 1e-3
    np.testing.assert_allclose(got["expert_weights"].numpy(),
                               np.asarray(want["expert_weights"]), atol=1e-3)
    with pytest.raises(ValueError, match="prepared for"):
        fwd(_port_model(variables), prepare_qexperts(pack, torch.float32, "cpu"),
            _torch_batch(batch))
