"""The port's fused multi-expert model (automoe_tpu_torch/models/fused_experts.py)
on the CPU: the grouped trunk against N separate port backbones, the
weight fusion, `FusedAutoMoE` against the port's `AutoMoE` on the same
weights (float32, rtol 1e-5 / atol 1e-6: the grouped convs sum the same
products as the separate ones), and against the JAX package's
`FusedAutoMoE` on `fuse_automoe_variables` of the same JAX variables, for
the simple and the full context (float32, rtol 1e-3 / atol 1e-4, the
model tolerance of tests/test_torch_port_models.py). One JAX AutoMoE is
initialised per context; its fused references run eagerly at 64 px."""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms

S, B, H = 64, 2, 4
EXACT = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-3, atol=1e-4)
CFG = {
    "experts": [
        {"type": "detection", "num_classes": 10},
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": H},
}
KEYS = ("waypoints", "speed", "speed_seq", "expert_weights", "context_features",
        "combined_features", "gate_logits")


def _cfg(context: str):
    cfg = copy.deepcopy(CFG)
    cfg["context"] = {"type": "full", "context_dim": 64} if context == "full" else {
        "type": "simple"}
    return cfg


def _batch(seed: int):
    rng = np.random.default_rng(seed)

    def col(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (B, 1)).astype(np.float32)

    return {
        "image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
        "speed": rng.uniform(0, 30, (B, H)).astype(np.float32),
        "steering": (rng.normal(size=(B, H)) * 0.2).astype(np.float32),
        "throttle": rng.uniform(0, 1, (B, H)).astype(np.float32),
        "brake": (rng.uniform(0, 1, (B, H)) < 0.3).astype(np.float32),
        "hour": col(0, 24), "minute": col(0, 60),
        "weather": {"rain": col(), "fog": col(), "wetness": col(), "sun_angle": col(-90, 90)},
        "road": {"road_type": col(0, 3), "curvature": col(-0.1, 0.1)},
    }


def _torch_batch(batch):
    return jax.tree.map(torch.from_numpy, batch)


def _perturbed_bn(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """BatchNorm affine and running statistics away from their identity init."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return module.eval()


@pytest.fixture(scope="module", params=["simple", "full"])
def jax_reference(request):
    """(config, JAX AutoMoE variables with perturbed norms, a batch, JAX
    FusedAutoMoE's outputs on the fused variables)."""
    from automoe_tpu.configs import load_model_config
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.models.fused_experts import FusedAutoMoE, fuse_automoe_variables
    from automoe_tpu.utils import jit_init

    cfg = _cfg(request.param)
    batch = _batch(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    v = jax.device_get(jit_init(create_automoe_model(cfg), jax.random.key(0), jbatch))
    rng = np.random.default_rng(4)
    variables = {"params": _perturb_norms(v["params"], rng),
                 "batch_stats": _perturb_norms(v["batch_stats"], rng)}
    jcfg = load_model_config(cfg)
    fused = fuse_automoe_variables(variables, jcfg)
    out = FusedAutoMoE(jcfg, dtype=jnp.float32).apply(fused, jbatch)
    return cfg, variables, batch, jax.device_get(out)


def test_grouped_trunk_equals_separate_backbones():
    from automoe_tpu_torch.models import ResNet18Backbone
    from automoe_tpu_torch.models.fused_experts import (
        FusedResNet18Trunk,
        fuse_backbone_params,
        split_fused_features,
    )

    torch.manual_seed(0)
    backbones = [_perturbed_bn(ResNet18Backbone(), seed) for seed in range(3)]
    trunk = FusedResNet18Trunk(3)
    trunk.load_state_dict(fuse_backbone_params([b.state_dict() for b in backbones]),
                          strict=True)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 72, 56)).astype(np.float32))
    with torch.no_grad():
        parts = split_fused_features(trunk.eval()(x), 3)
        for b, part in zip(backbones, parts):
            want = b(x)
            assert part.shape == want.shape == (2, 512, 3, 2)
            np.testing.assert_allclose(part.numpy(), want.numpy(), **EXACT)


def test_fuse_expert_variables_takes_each_experts_trunk():
    """Detection, drivable and nuScenes expert state dicts (`backbone.*`,
    `image_backbone.*`) → the fused trunk's names, weights concatenated on
    dim 0."""
    from automoe_tpu_torch.models import BDDDetectionExpert, BDDDrivableExpert, NuScenesExpert
    from automoe_tpu_torch.models.fused_experts import (
        FusedResNet18Trunk,
        fuse_expert_variables,
    )

    torch.manual_seed(1)
    experts = [BDDDetectionExpert(), BDDDrivableExpert(), NuScenesExpert(num_queries=4)]
    fused = fuse_expert_variables([e.state_dict() for e in experts])
    assert sorted(fused) == sorted(FusedResNet18Trunk(3).state_dict())
    w = fused["layer2_0.downsample_conv.weight"]
    assert w.shape == (384, 64, 1, 1)
    torch.testing.assert_close(w[128:256], experts[1].backbone[5][0].downsample[0].weight,
                               rtol=0, atol=0)
    torch.testing.assert_close(fused["bn1.running_var"][128:],
                               experts[2].image_backbone[1].running_var, rtol=0, atol=0)


@pytest.mark.parametrize("context", ["simple", "full"])
def test_fused_automoe_equals_automoe(context):
    from automoe_tpu_torch.models import create_automoe_model
    from automoe_tpu_torch.models.fused_experts import (
        create_fused_automoe_model,
        fuse_automoe_state_dict,
    )

    cfg = _cfg(context)
    model = _perturbed_bn(create_automoe_model(cfg, device="cpu", seed=2), seed=7)
    fused = create_fused_automoe_model(cfg, fuse_automoe_state_dict(model.state_dict(), cfg),
                                       device="cpu")
    batch = _torch_batch(_batch(8))
    with torch.no_grad():
        want, got = model(batch), fused(batch)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **EXACT, err_msg=k)
    for i, (g, w) in enumerate(zip(got["expert_outputs"], want["expert_outputs"])):
        for k in (w if isinstance(w, dict) else [None]):
            a, b = (g[k], w[k]) if k else (g, w)
            assert a.shape == b.shape, (i, k)
            np.testing.assert_allclose(a.numpy(), b.numpy(), **EXACT, err_msg=f"{i} {k}")


def test_fused_automoe_matches_jax(jax_reference):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.configs import load_model_config
    from automoe_tpu_torch.models.fused_experts import (
        create_fused_automoe_model,
        fuse_automoe_state_dict,
    )

    cfg, variables, batch, ref = jax_reference
    pcfg = load_model_config(cfg)
    sd = fuse_automoe_state_dict(state_dict_from_jax(variables, pcfg), pcfg)
    model = create_fused_automoe_model(pcfg, sd, device="cpu")
    with torch.no_grad():
        got = model(_torch_batch(batch))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    det, drv, nus = got["expert_outputs"]
    rdet, rdrv, rnus = ref["expert_outputs"]
    for k in ("class_logits", "bbox_deltas"):  # NCHW here, NHWC in JAX
        np.testing.assert_allclose(det[k].permute(0, 2, 3, 1).numpy(), rdet[k], **TOL)
    np.testing.assert_allclose(drv.permute(0, 2, 3, 1).numpy(), rdrv, **TOL)
    for k in ("class_logits", "bbox_preds"):
        np.testing.assert_allclose(nus[k].numpy(), rnus[k], **TOL)


def test_fused_automoe_rejects_a_lidar_expert():
    from automoe_tpu_torch.models.fused_experts import FusedAutoMoE

    cfg = copy.deepcopy(CFG)
    cfg["experts"][2].update(use_lidar=True)
    with pytest.raises(NotImplementedError, match="image-only"):
        FusedAutoMoE(cfg)
