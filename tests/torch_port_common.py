"""Shared set-up of the tests that hold the PyTorch port
(automoe_tpu_torch) against the JAX package on the CPU: the small
topology, JAX variables with non-trivial normalisation statistics, and
the port's model on the same weights. Inputs come from numpy generators.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

B, S = 2, 64
CAM_HW = (96, 128)


def small_config():
    """The shipped 4-expert topology with 8 nuScenes queries (JAX config)."""
    from automoe_tpu.configs import default_model_config

    cfg = default_model_config()
    experts = list(cfg.experts)
    experts[3] = dataclasses.replace(experts[3], num_queries=8)
    return dataclasses.replace(cfg, experts=experts)


def port_config(cfg):
    from automoe_tpu_torch.configs import load_model_config

    return load_model_config(cfg.to_json())


def make_batch(seed: int, b: int = B, s: int = S):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(b, s, s, 3)).astype(np.float32),
        "speed": rng.uniform(0, 30, size=(b, 1)).astype(np.float32),
        "steering": np.zeros((b, 1), np.float32),
        "throttle": np.zeros((b, 1), np.float32),
        "brake": np.zeros((b, 1), np.float32),
    }


def _perturb_norms(tree, rng, path=()):
    """BatchNorm/LayerNorm leaves away from their identity init, so that
    folding or normalisation mistakes cannot hide."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_norms(v, rng, path + (k,))
            continue
        v = np.array(v)  # a writable copy
        in_norm = any(p.startswith(("bn", "downsample_bn", "ln")) for p in path)
        if in_norm and k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        elif in_norm and k in ("bias", "mean"):
            v = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        out[k] = v
    return out


def jax_model_and_variables(seed: int = 0):
    """(JAX AutoMoE with fast_gating_pool, numpy variables)."""
    from automoe_tpu.models import create_automoe_model
    from automoe_tpu.utils import jit_init

    cfg = small_config()
    model = create_automoe_model(cfg, fast_gating_pool=True)
    init = {k: jnp.asarray(v) for k, v in make_batch(seed).items()}
    variables = jit_init(model, jax.random.key(seed), init)
    rng = np.random.default_rng(seed + 100)
    return model, {
        "params": _perturb_norms(jax.device_get(variables["params"]), rng),
        "batch_stats": _perturb_norms(jax.device_get(variables["batch_stats"]), rng),
    }


def port_model(cfg, variables):
    """The port's AutoMoE (fast_gating_pool, float32, CPU) on JAX weights."""
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.models import create_automoe_model

    model = create_automoe_model(port_config(cfg), fast_gating_pool=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, port_config(cfg)), strict=True)
    return model


def to_torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.abs(a - b).mean() / (np.abs(a).mean() + 1e-12))
