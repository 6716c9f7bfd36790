"""The port's pipeline parallelism (automoe_tpu_torch/parallel/pp.py)
against the JAX package's on the CPU, each rank a gloo subprocess
(tests/torch_port_ranks.py); every JAX reference comes from the one
module fixture, on conftest's 8-device CPU mesh:

* `pipeline_apply(mlp_block)` over 4 ranks against JAX's on a (1, 4)
  mesh, 4 microbatches, on init_mlp_stack's draws: forward rtol 1e-6 /
  atol 1e-6, the gradients of mean(y²) (each stage's and the input's)
  rtol 1e-5 / atol 1e-5;
* a block non-finite at zero (an rsqrt norm) over 4 ranks: finite, and
  equal to JAX's pipeline (rtol 2e-5 / atol 2e-6);
* the deep policy with its trunk (depth 4, width 16) through
  `grouped_pipeline_apply` over 2 ranks against JAX's DeepTrajectoryPolicy
  with the same trunk_apply on a (1, 2) mesh: outputs within 1e-6, every
  gradient within 1e-5 (rtol 1e-4);
* the validation errors with JAX's words;
* `automoe-train-torch policy --trunk-depth 4 --pp-microbatches 2
  --model-axis 2` on 2 ranks against the same seed at `--no-mesh`:
  losses rtol 1e-4, parameters rtol 1e-3 / atol 1e-5 (AdamW), the
  checkpoint holding the whole [L] stack, which one process resumes.
"""
from __future__ import annotations

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
from tests.torch_port_ranks import run_ranks

S, D, HID, B, M = 4, 32, 64, 16, 4
L, C, G, BD, IMG, BT, H = 4, 16, 8, 32, 32, 4, 4


def _norm_block(params, h):
    g = h * jax.lax.rsqrt(jnp.mean(h ** 2, axis=-1, keepdims=True))
    return h + jnp.maximum(g @ params["w1"] + params["b1"], 0.0) @ params["w2"]


@pytest.fixture(scope="module")
def ref(module_tmp):
    from automoe_tpu.models.deep_policy import DeepTrajectoryPolicy
    from automoe_tpu.parallel import MeshSpec, make_mesh
    from automoe_tpu.parallel.pp import (grouped_pipeline_apply, init_mlp_stack, mlp_block,
                                         pipeline_apply, stage_param_sharding)

    out = {"dir": module_tmp("pp_ref")}
    params = init_mlp_stack(0, S, D, HID)
    x = np.random.default_rng(1).normal(size=(B, D)).astype(np.float32)
    mesh4 = make_mesh(MeshSpec(data=1, model=S), devices=jax.devices()[:S])
    placed = jax.device_put(params, stage_param_sharding(mesh4))

    def loss(p, h):
        return jnp.mean(pipeline_apply(mlp_block, p, h, mesh4, microbatches=M) ** 2)

    out["mlp_y"] = np.asarray(jax.jit(lambda p, h: pipeline_apply(
        mlp_block, p, h, mesh4, microbatches=M))(placed, x))
    out["mlp_loss"], (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(placed, x)
    out["mlp_grads"] = jax.device_get(gp)
    out["mlp_dx"] = np.asarray(gx)
    out["norm_y"] = np.asarray(jax.jit(lambda p, h: pipeline_apply(
        _norm_block, p, h, mesh4, microbatches=M))(placed, x))
    torch.save({"params": {k: torch.from_numpy(v) for k, v in params.items()},
                "x": torch.from_numpy(x)}, out["dir"] / "mlp.pt")

    # the deep policy, its trunk grouped over a (1, 2) mesh
    rng = np.random.default_rng(2)
    image = rng.normal(size=(BT, IMG, IMG, 3)).astype(np.float32)
    model = DeepTrajectoryPolicy(horizon=H, context_dim=0, backbone_dim=BD, depth=L, width=C,
                                 groups=G)
    dparams = jax.device_get(model.init(jax.random.key(3), image, None)["params"])
    mesh2 = make_mesh(MeshSpec(data=1, model=2), devices=jax.devices()[:2])
    trunk = functools.partial(grouped_pipeline_apply, mesh=mesh2, microbatches=2)

    def dloss(p):
        o = model.apply({"params": p}, image, None, trunk_apply=trunk)
        return jnp.mean(o["waypoints"] ** 2) + jnp.mean(o["speed"] ** 2), o

    (dl, dout), dgrads = jax.jit(jax.value_and_grad(dloss, has_aux=True))(dparams)
    out["deep"] = dict(params=dparams, loss=float(dl), out=jax.device_get(dout),
                       grads=jax.device_get(dgrads), image=image)
    return out


def test_pipeline_apply_matches_jax(ref, tmp_path):
    res = run_ranks("pipeline", S, tmp_path, str(ref["dir"] / "mlp.pt"), M, "mlp")
    for r in range(S):  # every stage leaves with the output
        np.testing.assert_allclose(res[r]["y"].numpy(), ref["mlp_y"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res[r]["dx"].numpy(), ref["mlp_dx"], rtol=1e-5, atol=1e-5)
        for k, g in res[r]["grads"].items():  # stage r's slice of the [S] stack
            np.testing.assert_allclose(g.numpy(), ref["mlp_grads"][k][r:r + 1], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_pipeline_nonfinite_at_zero_block(ref, tmp_path):
    """The drain ticks run the block on zero buffers, where this one is
    inf; the outputs are collected with a where, so none leaks."""
    res = run_ranks("pipeline", S, tmp_path, str(ref["dir"] / "mlp.pt"), M, "norm")
    for r in range(S):
        y = res[r]["y"].numpy()
        assert np.isfinite(y).all()
        np.testing.assert_allclose(y, ref["norm_y"], rtol=2e-5, atol=2e-6)


def test_deep_trunk_grouped_pipeline_matches_jax(ref, tmp_path):
    from automoe_tpu_torch.ckpt import deep_policy_state_dict_from_jax

    deep = ref["deep"]
    state = deep_policy_state_dict_from_jax({"params": deep["params"]})
    f = tmp_path / "deep.pt"
    torch.save({"kw": dict(horizon=H, context_dim=0, backbone_dim=BD, depth=L, width=C,
                           groups=G), "state": state,
                "image": torch.from_numpy(deep["image"])}, f)
    res = run_ranks("deep_trunk", 2, tmp_path / "ranks", str(f), 2)
    want = deep_policy_state_dict_from_jax({"params": deep["grads"]})
    for r in range(2):
        np.testing.assert_allclose(float(res[r]["loss"]), deep["loss"], rtol=1e-6)
        for k in ("waypoints", "speed"):
            np.testing.assert_allclose(res[r]["out"][k].numpy(), deep["out"][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        for k, g in res[r]["grads"].items():
            w = want[k]
            if k.startswith("pipeline_blocks."):  # this rank's 2 of the 4 blocks
                w = w[2 * r:2 * r + 2]
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_pipeline_validation_errors():
    from automoe_tpu_torch.parallel.pp import (init_mlp_stack, mlp_block, pipeline_apply,
                                               stage_param_sharding)
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer

    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2}, model_index=0)
    params = {k: torch.from_numpy(v[:1]) for k, v in init_mlp_stack(0, 2, 8, 8).items()}
    x = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="divide"):
        pipeline_apply(mlp_block, params, x, mesh, microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(mlp_block, params, x, mesh, microbatches=0)
    with pytest.raises(ValueError, match=r"block count 3 must divide by the mesh 'model' "
                                         r"axis \(2\)"):
        stage_param_sharding(mesh)({"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match=r"needs a mesh with a 'model' axis > 1"):
        Trainer(None, [], [], TrainConfig(pp_microbatches=2, device="cpu"))


@pytest.fixture(scope="module")
def seq_root(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    return synth_carla_sequence(module_tmp("pp_seq"), n_per_split={"train": 24, "val": 16},
                                size=IMG)


def _policy_argv(seq_root, out, *extra):
    return ["policy", "--data-root", str(seq_root), "--image-size", str(IMG), "--trunk-depth",
            str(L), "--trunk-width", str(C), "--horizon", str(H), "--batch-size", "4",
            "--epochs", "1", "--num-workers", "1", "--device", "cpu", "--seed", "5",
            "--ckpt-root", str(out / "ckpt"), "--runs-root", str(out / "runs"), *extra]


def test_policy_cli_pipeline_equals_no_mesh(seq_root, tmp_path):
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.train.cli import main

    torch.manual_seed(0)
    main(_policy_argv(seq_root, tmp_path / "one", "--no-mesh"))
    run_ranks("cli", 2, tmp_path / "ranks",
              _policy_argv(seq_root, tmp_path / "pp", "--pp-microbatches", "2",
                           "--model-axis", "2"))

    def epoch_losses(root):
        recs = [json.loads(r) for r in (root / "runs" / "carla_policy_run" / "metrics.jsonl")
                .read_text().splitlines()]
        return [r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r]

    def state(root):
        return load_checkpoint(root / "ckpt" / "carla_policy" / "run" / "last.pt")

    np.testing.assert_allclose(epoch_losses(tmp_path / "pp"), epoch_losses(tmp_path / "one"),
                               rtol=1e-4)
    one, pp = state(tmp_path / "one"), state(tmp_path / "pp")
    assert tuple(pp["model_state_dict"]["pipeline_blocks.conv1"].shape) == (L, C, C, 3, 3)
    assert tuple(pp["optimizer"]["state"]["pipeline_blocks.conv1"][0].shape) == (L, C, C, 3, 3)
    np.testing.assert_allclose(pp["best_val_loss"], one["best_val_loss"], rtol=1e-4)
    for k, v in one["model_state_dict"].items():
        torch.testing.assert_close(pp["model_state_dict"][k], v, rtol=1e-3, atol=1e-5, msg=k)
    # the pipelined run's checkpoint resumes in one process (--no-mesh)
    res = main(_policy_argv(seq_root, tmp_path / "pp", "--no-mesh", "--epochs", "2",
                            "--resume", "full"))
    assert np.isfinite(res["best_val_loss"])
    assert state(tmp_path / "pp")["epoch"] == 1
