"""Each module of the PyTorch port (automoe_tpu_torch/models) against its
flax counterpart in float32 on identical weights and inputs, and the
whole AutoMoE(fast_gating_pool=True). Bound: rtol 1e-3 / atol 1e-4 (the
JAX side runs at the highest matmul precision)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import (
    B,
    S,
    jax_model_and_variables,
    make_batch,
    nchw,
    nhwc,
    port_model,
    small_config,
    to_torch_batch,
)

TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jmodel, variables = jax_model_and_variables(seed=1)
    return jmodel, variables, port_model(small_config(), variables)


def _sub(variables, name):
    out = {"params": variables["params"][name]}
    if name in variables["batch_stats"]:
        out["batch_stats"] = variables["batch_stats"][name]
    return out


def _image(seed=11):
    return np.random.default_rng(seed).normal(size=(B, S, S, 3)).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw,antialias", [
    ((600, 800), (256, 256), True),  # the camera frame; W contracted first
    ((48, 64), (96, 80), False),  # an upsample; H contracted first
])
def test_resize_bilinear(in_hw, out_hw, antialias):
    from automoe_tpu.ops.resize import resize_bilinear as jax_resize
    from automoe_tpu_torch.ops.resize import resize_bilinear

    x = np.random.default_rng(9).uniform(size=(2, *in_hw, 3)).astype(np.float32)
    want = jax_resize(jnp.asarray(x), *out_hw, antialias=antialias)
    got = resize_bilinear(torch.from_numpy(x), *out_hw, antialias=antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("include_pool", [False, True])
def test_resnet_backbone(models, include_pool):
    from automoe_tpu.models.resnet import ResNet18Backbone

    _, variables, pm = models
    x = _image()
    if include_pool:
        ref = ResNet18Backbone(include_pool=True).apply(
            _sub(_sub(variables, "expert_3"), "image_backbone"), jnp.asarray(x))
        got = pm.experts[3].image_backbone(nchw(x)).detach().numpy()
    else:
        ref = ResNet18Backbone().apply(
            _sub(_sub(variables, "expert_0"), "backbone"), jnp.asarray(x))
        got = nhwc(pm.experts[0].backbone(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("idx,upsample", [(0, True), (1, False), (1, True),
                                          (2, False), (3, True)])
def test_expert(models, idx, upsample):
    from automoe_tpu.models import experts as jx
    from automoe_tpu_torch.models import experts as px

    _, variables, pm = models
    ecfg = small_config().experts[idx]
    x = _image(12 + idx)
    expert = pm.experts[idx]
    if ecfg.type == "detection":
        jm = jx.BDDDetectionExpert(ecfg.num_classes)
        ref = jm.apply(_sub(variables, "expert_0"), jnp.asarray(x))
        got = expert(nchw(x))
        for k in ("class_logits", "bbox_deltas"):
            np.testing.assert_allclose(nhwc(got[k]), np.asarray(ref[k]), **TOL)
        return
    if ecfg.type == "nuscenes":
        jm = jx.NuScenesExpert(num_queries=ecfg.num_queries, fusion=ecfg.fusion,
                               bbox_dim=ecfg.bbox_dim, num_classes=ecfg.num_classes)
        ref = jm.apply(_sub(variables, "expert_3"), {"image": jnp.asarray(x)})
        got = expert(nchw(x))
        for k in ("class_logits", "bbox_preds"):
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), **TOL)
        return
    cls = {"segmentation": (jx.BDDSegmentationExpert, px.BDDSegmentationExpert),
           "drivable": (jx.BDDDrivableExpert, px.BDDDrivableExpert)}[ecfg.type]
    jm = cls[0](ecfg.num_classes, upsample=upsample)
    ref = jm.apply(_sub(variables, f"expert_{idx}"), jnp.asarray(x))
    if upsample != expert.upsample:  # same weights, other output mode
        other = cls[1](ecfg.num_classes, upsample=upsample)
        other.load_state_dict(expert.state_dict())
        expert = other.eval()
    got = nhwc(expert(nchw(x)))
    assert got.shape == np.asarray(ref).shape
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("idx,use_uv", [(0, False), (1, False), (1, True),
                                        (2, True), (3, False)])
def test_extractor(models, idx, use_uv):
    from automoe_tpu.models.extractors import make_extractor
    from automoe_tpu.ops.resize import mean_of_resize_weights

    _, variables, pm = models
    ecfg = small_config().experts[idx]
    rng = np.random.default_rng(20 + idx)
    h = w = S // 32
    if ecfg.type == "detection":
        jout = {"class_logits": rng.normal(size=(B, h, w, ecfg.num_classes)),
                "bbox_deltas": rng.normal(size=(B, h, w, 4))}
        pout = {k: nchw(v.astype(np.float32)) for k, v in jout.items()}
    elif ecfg.type == "nuscenes":
        jout = {"class_logits": rng.normal(size=(B, ecfg.num_queries, ecfg.num_classes)),
                "bbox_preds": rng.normal(size=(B, ecfg.num_queries, ecfg.bbox_dim))}
        pout = {k: torch.from_numpy(v.astype(np.float32)) for k, v in jout.items()}
    else:
        jout = rng.normal(size=(B, h, w, ecfg.num_classes))
        pout = nchw(jout.astype(np.float32))
    jout = {k: jnp.asarray(v, jnp.float32) for k, v in jout.items()} \
        if isinstance(jout, dict) else jnp.asarray(jout, jnp.float32)
    uv = mean_of_resize_weights(h, w, S, S, False) if use_uv else None
    ref = make_extractor(ecfg, pool_uv=uv).apply(
        {"params": variables["params"][f"extractor_{idx}"]}, jout)
    puv = tuple(torch.from_numpy(a) for a in uv) if use_uv else None
    got = pm.expert_extractors.extractors[idx](pout, pool_uv=puv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_context_extractor(models):
    from automoe_tpu.models.context import SimpleContextExtractor

    _, variables, pm = models
    cols = [np.random.default_rng(30 + i).normal(size=(B, 1)).astype(np.float32)
            for i in range(4)]
    ref = SimpleContextExtractor(64).apply(
        {"params": variables["params"]["context_extractor"]}, *map(jnp.asarray, cols))
    got = pm.context_extractor(*map(torch.from_numpy, cols))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_gating_network(models):
    from automoe_tpu.models.gating import gating_network_from_config

    _, variables, pm = models
    cfg = small_config()
    rng = np.random.default_rng(40)
    feats = [rng.normal(size=(B, e.output_dim)).astype(np.float32) for e in cfg.experts]
    ctx = rng.normal(size=(B, cfg.context.context_dim)).astype(np.float32)
    ref = gating_network_from_config(cfg, jnp.float32).apply(
        {"params": variables["params"]["gating_network"]},
        [jnp.asarray(f) for f in feats], jnp.asarray(ctx))
    got = pm.gating_network([torch.from_numpy(f) for f in feats], torch.from_numpy(ctx))
    for k in ("combined_output", "expert_weights", "gate_logits"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)


def test_policy_head(models):
    from automoe_tpu.models.policy import TrajectoryPolicy

    _, variables, pm = models
    cfg = small_config()
    x = _image(50)
    ctx = np.random.default_rng(51).normal(size=(B, 256)).astype(np.float32)
    ref = TrajectoryPolicy(horizon=cfg.policy.num_waypoints, context_dim=256).apply(
        _sub(variables, "policy_head"), jnp.asarray(x), jnp.asarray(ctx))
    got = pm.policy_head(nchw(x), torch.from_numpy(ctx))
    for k in ("waypoints", "speed"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), **TOL)


def test_automoe_fast_gating_pool(models):
    jmodel, variables, pm = models
    batch = make_batch(60)
    ref = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = pm(to_torch_batch(batch))
    for k in ("waypoints", "speed", "speed_seq", "expert_weights", "context_features",
              "combined_features", "gate_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    # low-res maps of the seg/drivable experts, class logits of nuScenes
    for i in (1, 2):
        np.testing.assert_allclose(nhwc(got["expert_outputs"][i]),
                                   np.asarray(ref["expert_outputs"][i]), **TOL)
    np.testing.assert_allclose(got["expert_outputs"][3]["class_logits"].numpy(),
                               np.asarray(ref["expert_outputs"][3]["class_logits"]), **TOL)


def test_gating_from_config_drops_topk_unless_honored():
    import dataclasses

    from automoe_tpu_torch.models.gating import gating_network_from_config
    from tests.torch_port_common import port_config

    cfg = port_config(small_config())
    assert cfg.gating.top_k == 2  # the shipped config asks for top-2 ...
    dropped = gating_network_from_config(cfg, device="cpu")  # ... the composite drops it
    assert (dropped.top_k, dropped.apply_topk_at_eval) == (0, False)
    honored = dataclasses.replace(
        cfg, gating=dataclasses.replace(cfg.gating, honor_topk_in_composite=True))
    g = gating_network_from_config(honored, device="cpu")  # ... unless honoured
    assert (g.top_k, g.apply_topk_at_eval, g.noise_scale) == (2, True, cfg.gating.noise_scale)
