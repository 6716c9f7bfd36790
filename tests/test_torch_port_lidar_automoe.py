"""An AutoMoE whose nuScenes expert has the LiDAR branch (PointNet with
its TNets, concat fusion) in the port against the JAX package on the CPU,
on the same weights and inputs, in float32:

* the eval-mode forward with the batch's points and without them (the JAX
  model then feeds 1000 zero points per frame, which a concat expert's
  512-wide queries need): waypoints, speed and expert weights rtol 1e-4 /
  atol 1e-5; the nuScenes expert's outputs rtol 1e-4 with atol 5e-5 of
  their largest magnitude (untrained PointNet outputs reach ~1e2 in eval
  mode, where float32 keeps ~1e-6 of that scale);
* the int8 serving forward (the PointNet beside the int8 image trunks),
  held on the JAX package's activation scales as the quant tests hold
  it: waypoints within 1e-3 mean relative error, expert weights within
  atol 1e-3.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms, rel_err

S, B, P = 64, 2, 96
CFG = {
    "experts": [
        {"type": "detection", "num_classes": 10},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 7, "fusion": "concat",
         "use_lidar": True, "use_tnet": True},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}


def _batch(seed, lidar=True):
    rng = np.random.default_rng(seed)
    out = {"image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
           "speed": rng.uniform(0, 30, (B, 1)).astype(np.float32)}
    if lidar:
        out["lidar"] = (rng.normal(size=(B, P, 3)) * rng.uniform(0.5, 2, (B, 1, 1))
                        + rng.normal(size=(B, 1, 3))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.utils import jit_init

    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.models import create_automoe_model as port_create

    jm = create_automoe_model(CFG, fast_gating_pool=True)
    v = jax.device_get(jit_init(jm, jax.random.key(0), {k: jnp.asarray(x)
                                                         for k, x in _batch(0).items()}))
    rng = np.random.default_rng(1)
    variables = {"params": _perturb_norms(v["params"], rng),
                 "batch_stats": _perturb_norms(v["batch_stats"], rng)}
    pm = port_create(CFG, fast_gating_pool=True, device="cpu")
    pm.load_state_dict(state_dict_from_jax(variables, CFG), strict=True)
    return jm, variables, pm


@pytest.mark.parametrize("lidar", [True, False], ids=["points", "zero-points"])
def test_lidar_automoe_forward_matches_jax(models, lidar):
    jm, variables, pm = models
    batch = _batch(5, lidar)
    want = jax.jit(lambda v, b: jm.apply(v, b))(variables, batch)
    with torch.no_grad():
        got = pm.eval()({k: torch.from_numpy(x) for k, x in batch.items()})
    for k in ("waypoints", "speed", "expert_weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k in ("class_logits", "bbox_preds"):
        w = np.asarray(want["expert_outputs"][1][k])
        np.testing.assert_allclose(got["expert_outputs"][1][k].numpy(), w, rtol=1e-4,
                                   atol=5e-5 * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("lidar", [True, False], ids=["points", "zero-points"])
def test_lidar_int8_forward_matches_jax(models, lidar):
    from automoe_tpu.serving import quant as jq

    from automoe_tpu_torch.serving.quant import (
        make_quant_forward,
        prepare_qexperts,
        quantize_automoe,
    )

    _, variables, pm = models
    calib = _batch(70, lidar=False)
    jpack = jq.quantize_automoe(variables, CFG, [{"image": jnp.asarray(calib["image"])}],
                                dtype=jnp.float32)
    batch = _batch(72, lidar)
    want = jq.make_quant_forward(CFG, jpack["scales"], dtype=jnp.float32)(
        variables, jpack["experts"], {k: jnp.asarray(v) for k, v in batch.items()})
    ppack = quantize_automoe(pm, [{"image": torch.from_numpy(calib["image"])}],
                             dtype=torch.float32)
    ppack["scales"] = jpack["scales"]  # the forward on shared scales (see the quant tests)
    fwd = make_quant_forward(CFG, ppack["scales"], dtype=torch.float32)
    got = fwd(pm, prepare_qexperts(ppack, torch.float32, "cpu"),
              {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["waypoints"].shape == tuple(want["waypoints"].shape)
    assert rel_err(want["waypoints"], got["waypoints"].numpy()) < 1e-3
    np.testing.assert_allclose(got["expert_weights"].numpy(), np.asarray(want["expert_weights"]),
                               atol=1e-3)
