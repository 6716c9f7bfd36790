"""The port's weight loading (automoe_tpu_torch/ckpt/from_jax.py) against
the JAX package's torch export: same names, same values, and a strict
load into the port's AutoMoE."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from automoe_tpu.ckpt.torch_export import export_automoe_state_dict, save_torch_checkpoint
from tests.torch_port_common import jax_model_and_variables, port_config, small_config


@pytest.fixture(scope="module")
def jax_vars():
    return jax_model_and_variables(seed=0)[1]


def test_state_dict_from_jax_equals_export(jax_vars):
    from automoe_tpu_torch.ckpt import state_dict_from_jax

    cfg = small_config()
    got = state_dict_from_jax(jax_vars, port_config(cfg))
    want = export_automoe_state_dict(jax_vars, cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k


def test_strict_load_into_port_model(jax_vars):
    from automoe_tpu_torch.ckpt import state_dict_from_jax
    from automoe_tpu_torch.models import create_automoe_model

    cfg = small_config()
    model = create_automoe_model(port_config(cfg), fast_gating_pool=True, device="cpu")
    sd = state_dict_from_jax(jax_vars, port_config(cfg))
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k].to(v.dtype), rtol=0, atol=0, msg=k)


def test_pth_loader_unwraps_and_strips_ddp_prefix(jax_vars, tmp_path):
    from automoe_tpu_torch.ckpt import load_torch_state_dict, state_dict_from_jax
    from automoe_tpu_torch.models import create_automoe_model

    cfg = small_config()
    # the JAX package's writer: {'model_state_dict': ...}
    path = tmp_path / "automoe.pth"
    save_torch_checkpoint(jax_vars, cfg, str(path), epoch=3)
    plain = load_torch_state_dict(str(path))
    ref = state_dict_from_jax(jax_vars, port_config(cfg))
    assert sorted(plain) == sorted(ref)
    # that writer stores num_batches_tracked as [1]; a strict load takes it
    model = create_automoe_model(port_config(cfg), fast_gating_pool=True, device="cpu")
    model.load_state_dict(plain, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)
    # a DDP-wrapped bare state dict
    ddp = tmp_path / "ddp.pth"
    torch.save({f"module.{k}": v for k, v in ref.items()}, ddp)
    stripped = load_torch_state_dict(str(ddp))
    assert sorted(stripped) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(stripped[k], ref[k], rtol=0, atol=0)
