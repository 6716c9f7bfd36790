"""The port's expert parallelism (automoe_tpu_torch/parallel/ep.py) on the
CPU, 4 gloo ranks a run (tests/torch_port_ranks.py), on the JAX test's
4-expert topology (tests/test_ep.py's CFG) at 64 px with BatchNorm
statistics moved off their identity init:

* the EP eval forward on a 1 x 4 mesh against JAX's `make_ep_forward` on
  a (1, 4) mesh of conftest's CPU devices (the one module fixture), the
  same weights (`state_dict_from_jax`): waypoints, speed, expert weights,
  gate logits and combined features rtol 1e-4 / atol 1e-5;
* two SGD steps of the EP gating workload at data=1 against two steps of
  the port's dense gating workload in one process (itself held against
  JAX in test_torch_port_gating.py), dropout live (drawn part by part
  from the key, so both draw the same masks): losses rtol 1e-5, every
  parameter and BatchNorm statistic rtol 1e-4 / atol 1e-5;
* the model-axis check with JAX's words.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms
from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
from tests.torch_port_ranks import run_ranks

CFG = {
    "experts": [
        {"type": "detection", "num_classes": 10},
        {"type": "segmentation", "num_classes": 19},
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}
B, S, E = 4, 64, 4
OUT_KEYS = ("waypoints", "speed_seq", "expert_weights", "gate_logits", "combined_features")


def _batch(seed: int, train: bool = False):
    rng = np.random.default_rng(seed)
    out = {"image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
           "speed": rng.uniform(0, 30, size=(B, 4 if train else 1)).astype(np.float32),
           "steering": np.zeros((B, 4 if train else 1), np.float32),
           "throttle": np.zeros((B, 4 if train else 1), np.float32),
           "brake": np.zeros((B, 4 if train else 1), np.float32)}
    if train:
        out["waypoints"] = (rng.normal(size=(B, 4, 2)) * 3).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ref(module_tmp):
    from automoe_tpu.configs import load_model_config
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.parallel import MeshSpec, make_mesh, replicate, shard_batch
    from automoe_tpu.parallel.ep import make_ep_forward
    from automoe_tpu.utils import jit_init

    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.configs import load_model_config as port_load

    cfg = load_model_config(CFG)
    batch = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jit_init(create_automoe_model(cfg), jax.random.key(0), jb)
    rng = np.random.default_rng(100)
    variables = {"params": _perturb_norms(jax.device_get(variables["params"]), rng),
                 "batch_stats": _perturb_norms(jax.device_get(variables["batch_stats"]), rng)}
    mesh = make_mesh(MeshSpec(data=1, model=E), devices=jax.devices()[:E])
    ep = make_ep_forward(cfg, mesh)(jax.device_put(variables, replicate(mesh)),
                                    shard_batch(jb, mesh))
    pcfg = port_load(cfg.to_json())
    f = module_tmp("ep_ref") / "ep.pt"
    torch.save({"config": cfg.to_json(), "state": state_dict_from_jax(variables, pcfg),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}, "rows": B,
                "train_batch": {k: torch.from_numpy(v) for k, v in _batch(1, True).items()}},
               f)
    return {"file": f, "ep": {k: np.asarray(ep[k]) for k in OUT_KEYS}, "config": pcfg}


@pytest.fixture(scope="module")
def ep_run(ref, module_tmp):
    return run_ranks("ep", E, module_tmp("ep_ranks"), str(ref["file"]), 1, 2)


def test_ep_forward_matches_jax(ref, ep_run):
    for r in range(E):  # every rank of the model group leaves with the outputs
        for k in OUT_KEYS:
            np.testing.assert_allclose(ep_run[r]["forward"][k].numpy(), ref["ep"][k],
                                       rtol=1e-4, atol=1e-5, err_msg=f"rank {r} {k}")


def test_ep_gating_steps_equal_dense(ref, ep_run):
    from automoe_tpu_torch.models.automoe import AutoMoE
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import gating_workload

    saved = torch.load(ref["file"], weights_only=False)
    model = AutoMoE(ref["config"])
    model.load_state_dict(saved["state"])
    wl = gating_workload(ref["config"])
    mask = wl.trainable_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    opt = make_optimizer(model.named_parameters(), learning_rate=0.05, total_steps=2,
                         optimizer="sgd", schedule="constant", trainable_mask=mask)
    step = make_train_step(wl.loss_fn)
    model.train()
    losses = [float(step(model, opt, saved["train_batch"], (7, i))["loss"]) for i in range(2)]
    for r in range(E):
        np.testing.assert_allclose(ep_run[r]["losses"], losses, rtol=1e-5)
        for k, v in model.state_dict().items():
            got = ep_run[r]["state"][k]
            if v.is_floating_point():
                torch.testing.assert_close(got, v, rtol=1e-4, atol=1e-5, msg=f"rank {r} {k}")
            else:
                assert torch.equal(got, v), (r, k)


def test_ep_needs_the_model_axis_to_equal_the_experts(ref):
    from automoe_tpu_torch.parallel.ep import ep_gating_workload, make_ep_forward

    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    for build in (make_ep_forward, ep_gating_workload):
        with pytest.raises(ValueError, match="EP needs mesh model axis == 4 experts, got 2"):
            build(ref["config"], mesh)
