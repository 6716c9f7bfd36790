"""The port's deep policy trunk (automoe_tpu_torch/models/deep_policy.py)
against the JAX package's on the CPU, on the same numpy inputs and the
same weights (carried across with `deep_policy_state_dict_from_jax`,
loaded strictly):

* `group_norm` and one `residual_block`: rtol 1e-5 / atol 1e-6;
* the whole `DeepTrajectoryPolicy` (depth 3, width 16, backbone_dim 32,
  32x32, B=4), with and without context, float32 (JAX at `highest`):
  rtol 1e-4 / atol 1e-5;
* the same forward in bf16: the port under bf16 autocast (GroupNorm in
  float32) against JAX's bf16 module (parameters cast to bf16): mean
  relative errors measured on this input at 4.4e-3 (waypoints) and
  4.3e-3 (speed), against float32 5.8e-3 / 5.0e-3 for the port and
  8.0e-3 / 3.5e-3 for JAX; each held under 2e-2;
* the init: each block's conv std within 3% of He's sqrt(2/(9C));
* three AdamW steps of `policy_workload(trunk_depth=3)` against the JAX
  Trainer's steps (constant schedule, clip 1.0, weight decay 1e-4): losses
  rtol 1e-4, every parameter rtol 1e-3 / atol 1e-5 (the trunk has no
  BatchNorm and no conv bias under a norm, so no zero-gradient noise
  leaf that AdamW would blow up);
* the CLI on `--device cpu`: train, resume, the `--pp-microbatches`
  messages, `--trunk-depth 0` still building EasyBackbone, and no GPU
  without `--device cpu` raising.
All JAX references come from one module fixture."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import nchw, rel_err
from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)

L, C, G, BD, S, B, H, CTX = 3, 16, 8, 32, 32, 4, 4, 8
LR = 1e-3


def _perturb_gn(tree, rng):
    """GroupNorm affines away from their identity init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_gn(v, rng)
            continue
        v = np.array(v)
        if "gn" in k and k.endswith("scale"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif "gn" in k and k.endswith("bias"):
            v = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        out[k] = v
    return out


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batches(seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    return [{
        "image": rng.normal(size=(B, S, S, 3)).astype(np.float32),
        "waypoints": (rng.normal(size=(B, H, 2)) * 3).astype(np.float32),
        "speed": rng.uniform(0, 30, (B, H)).astype(np.float32),
        "context": rng.uniform(0, 1, (B, CTX)).astype(np.float32),
    } for _ in range(n)]


@pytest.fixture(scope="module")
def ref(module_tmp):
    """Every JAX reference of the module."""
    from automoe_tpu.models.deep_policy import (
        DeepTrajectoryPolicy,
        group_norm,
        residual_block,
    )
    from automoe_tpu.train.loop import TrainConfig as JaxConfig
    from automoe_tpu.train.loop import Trainer as JaxTrainer
    from automoe_tpu.train.state import TrainState
    from automoe_tpu.train.workloads import policy_workload

    rng = np.random.default_rng(0)
    out = {}
    h = rng.normal(size=(B, 8, 8, C)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.normal(size=C).astype(
        np.float32)
    out["gn_in"] = (h, scale, bias)
    out["gn"] = np.asarray(group_norm(jnp.asarray(h), scale, bias, G))
    block = {"conv1": rng.normal(size=(3, 3, C, C)).astype(np.float32) * 0.1,
             "conv2": rng.normal(size=(3, 3, C, C)).astype(np.float32) * 0.1,
             **{k: v.reshape(1, 1, 1, C) for k, v in (
                 ("gn1_scale", scale), ("gn1_bias", bias),
                 ("gn2_scale", scale[::-1].copy()), ("gn2_bias", bias[::-1].copy()))}}
    out["block_in"] = (h, block)
    out["block"] = np.asarray(residual_block({k: jnp.asarray(v) for k, v in block.items()},
                                             jnp.asarray(h), groups=G))

    image = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    ctx = rng.uniform(0, 1, (B, CTX)).astype(np.float32)
    out["image"], out["context"] = image, ctx
    for context_dim in (0, CTX):
        model = DeepTrajectoryPolicy(horizon=H, context_dim=context_dim, backbone_dim=BD,
                                     depth=L, width=C, groups=G)
        c = ctx if context_dim else None
        params = jax.device_get(model.init(jax.random.key(context_dim), image, c)["params"])
        params = _perturb_gn(params, rng)
        out[f"params{context_dim}"] = params
        out[f"fwd{context_dim}"] = jax.device_get(
            model.apply({"params": _jnp(params)}, image, c))
    bf = DeepTrajectoryPolicy(horizon=H, context_dim=CTX, backbone_dim=BD, depth=L, width=C,
                              groups=G, dtype=jnp.bfloat16)
    out["fwd_bf16"] = jax.device_get(
        bf.apply({"params": _jnp(out[f"params{CTX}"])}, image, ctx))

    # three AdamW steps through the JAX Trainer from perturbed weights
    batches = _batches(6)
    tmp = module_tmp("jax_traj")
    kw = dict(epochs=1, learning_rate=LR, weight_decay=1e-4, optimizer="adamw",
              schedule="constant", runs_root=str(tmp / "runs"), ckpt_root=str(tmp / "ckpt"))
    jtr = JaxTrainer(policy_workload(horizon=H, context_dim=CTX, backbone_dim=BD,
                                     image_size=S, trunk_depth=L, trunk_width=C),
                     batches, batches, JaxConfig(run_name="j", log_every=1, max_inflight=0,
                                                 **kw))
    init = _perturb_gn(jax.device_get(jtr.state.params), rng)
    jtr.state = TrainState.create(params=_jnp(init), tx=jtr.state.tx, batch_stats={})
    jtr.train_epoch(0)
    jtr.logger.close()
    recs = [json.loads(line) for line in
            (tmp / "runs" / "carla_policy_j" / "metrics.jsonl").read_text().splitlines()]
    out["traj"] = dict(batches=batches, kw=kw, init=init,
                       final=jax.device_get(jtr.state.params),
                       losses=[r["train/loss"] for r in recs if "train/loss" in r])
    return out


def _port(params, context_dim):
    from automoe_tpu_torch.ckpt import deep_policy_state_dict_from_jax
    from automoe_tpu_torch.models.deep_policy import DeepTrajectoryPolicy

    model = DeepTrajectoryPolicy(horizon=H, context_dim=context_dim, backbone_dim=BD, depth=L,
                                 width=C, groups=G)
    model.load_state_dict(deep_policy_state_dict_from_jax({"params": params}), strict=True)
    return model.eval()


def test_group_norm_matches_jax(ref):
    from automoe_tpu_torch.models.deep_policy import group_norm

    h, scale, bias = ref["gn_in"]
    got = group_norm(nchw(h), torch.from_numpy(scale), torch.from_numpy(bias), G)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref["gn"], rtol=1e-5,
                               atol=1e-6)


def test_residual_block_matches_jax(ref):
    from automoe_tpu_torch.models.deep_policy import residual_block

    h, block = ref["block_in"]
    params = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
              if k.startswith("conv") else torch.from_numpy(v.reshape(-1))
              for k, v in block.items()}
    got = residual_block(params, nchw(h), groups=G)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref["block"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("context_dim", [0, CTX], ids=["image-only", "context"])
def test_deep_policy_forward_matches_jax(ref, context_dim):
    model = _port(ref[f"params{context_dim}"], context_dim)
    ctx = torch.from_numpy(ref["context"]) if context_dim else None
    with torch.no_grad():
        got = model(nchw(ref["image"]), ctx)
    want = ref[f"fwd{context_dim}"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_deep_policy_bf16_matches_jax_bf16(ref):
    """bf16 has no exact counterpart (autocast keeps GroupNorm in float32,
    JAX rounds its parameters to bf16): both are held against each other
    and against the float32 forward."""
    model = _port(ref[f"params{CTX}"], CTX)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = model(nchw(ref["image"]), torch.from_numpy(ref["context"]))
    for k in ("waypoints", "speed"):
        port, jax_bf, f32 = (got[k].float().numpy(), np.asarray(ref["fwd_bf16"][k], np.float32),
                             ref[f"fwd{CTX}"][k])
        assert np.isfinite(port).all()
        assert rel_err(jax_bf, port) < 2e-2, (k, rel_err(jax_bf, port))
        assert rel_err(f32, port) < 2e-2 and rel_err(f32, jax_bf) < 2e-2, k


def test_from_jax_loads_strictly_with_the_stacked_layout(ref):
    model = _port(ref["params0"], 0)
    blocks = model.pipeline_blocks
    assert tuple(blocks.conv1.shape) == tuple(blocks.conv2.shape) == (L, C, C, 3, 3)
    for k in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias"):
        assert tuple(getattr(blocks, k).shape) == (L, C)
    want = ref["params0"]["pipeline_blocks"]["conv1"][1]  # block 1, HWIO
    np.testing.assert_array_equal(blocks.conv1[1].detach().numpy(), want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("depth,width", [(16, 128), (4, 32)])
def test_init_per_block_std_is_he(depth, width):
    """Each block's conv std within 3% of sqrt(2/(9C)) (a draw over the
    stacked shape's fan would be sqrt(L) too small); GroupNorm at 1 / 0."""
    from automoe_tpu_torch.train.workloads import policy_workload

    model = policy_workload(trunk_depth=depth, trunk_width=width).init_model(0, "cpu")
    blocks = model.pipeline_blocks
    want = np.sqrt(2.0 / (9 * width))
    for w in (blocks.conv1, blocks.conv2):
        std = w.detach().reshape(depth, -1).std(dim=1).numpy()
        assert np.all(np.abs(std / want - 1) < 0.03), std / want
        # truncated at two of the draw's std
        assert float(w.detach().abs().max()) <= 2 * want / 0.87962566103423978 + 1e-6
    assert torch.equal(blocks.gn1_scale, torch.ones(depth, width))
    assert torch.equal(blocks.gn2_bias, torch.zeros(depth, width))
    # a second seed draws other weights
    other = policy_workload(trunk_depth=depth, trunk_width=width).init_model(1, "cpu")
    assert not torch.equal(other.pipeline_blocks.conv1, blocks.conv1)


@pytest.fixture(scope="module")
def port_traj(ref, module_tmp):
    from automoe_tpu_torch.ckpt import deep_policy_state_dict_from_jax
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import policy_workload

    t = ref["traj"]
    tmp = module_tmp("port_traj")
    kw = {**t["kw"], "runs_root": str(tmp / "runs"), "ckpt_root": str(tmp / "ckpt")}
    tr = Trainer(policy_workload(horizon=H, context_dim=CTX, backbone_dim=BD, image_size=S,
                                 trunk_depth=L, trunk_width=C), t["batches"], t["batches"],
                 TrainConfig(run_name="p", device="cpu", log_every=1, **kw))
    tr.model.load_state_dict(deep_policy_state_dict_from_jax({"params": t["init"]}),
                             strict=True)
    tr.train_epoch(0)
    tr.logger.close()
    recs = [json.loads(line) for line in
            (tmp / "runs" / "carla_policy_p" / "metrics.jsonl").read_text().splitlines()]
    return {"losses": [r["train/loss"] for r in recs if "train/loss" in r],
            "final": {k: v.detach() for k, v in tr.model.state_dict().items()},
            "want": deep_policy_state_dict_from_jax({"params": t["final"]})}


def test_adamw_trajectory_losses_match_jax(ref, port_traj):
    assert len(port_traj["losses"]) == 3
    np.testing.assert_allclose(port_traj["losses"], ref["traj"]["losses"], rtol=1e-4)


@pytest.mark.parametrize("group", ["stem_", "pipeline_blocks.", "fc.", "head_wp.", "head_spd."])
def test_adamw_trajectory_state_matches_jax(port_traj, group):
    got, want = port_traj["final"], port_traj["want"]
    keys = [k for k in want if k.startswith(group)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq_root(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_carla_sequence

    return synth_carla_sequence(module_tmp("seq"), n_per_split={"train": 16, "val": 12},
                                size=S, seed=3)


def _argv(root, tmp, *extra):
    return ["policy", "--data-root", str(root), "--image-size", str(S), "--horizon", str(H),
            "--trunk-depth", "2", "--trunk-width", "16", "--batch-size", "4", "--num-workers",
            "1", "--device", "cpu", "--ckpt-root", str(tmp / "ckpt"), "--runs-root",
            str(tmp / "runs"), *extra]


def test_cli_deep_policy_trains_and_resumes(seq_root, tmp_path):
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.train.cli import main

    res = main(_argv(seq_root, tmp_path, "--epochs", "1", "--bf16"))
    assert np.isfinite(res["best_val_loss"])
    best = tmp_path / "ckpt" / "carla_policy" / "run" / "best.pt"
    sd = load_checkpoint(best)["model_state_dict"]
    assert tuple(sd["pipeline_blocks.conv1"].shape) == (2, 16, 16, 3, 3)
    res = main(_argv(seq_root, tmp_path, "--epochs", "2", "--resume", "full"))
    last = load_checkpoint(tmp_path / "ckpt" / "carla_policy" / "run" / "last.pt")
    assert last["epoch"] == 1 and np.isfinite(res["best_val_loss"])
    recs = [json.loads(line) for line in (tmp_path / "runs" / "carla_policy_run" /
                                          "metrics.jsonl").read_text().splitlines()]
    assert len([r for r in recs if "val/loss" in r]) == 2


@pytest.mark.parametrize("depth,match", [
    ("0", "needs --trunk-depth > 0"), ("2", "--pp-microbatches needs --model-axis > 1")])
def test_cli_pp_microbatches_messages(seq_root, tmp_path, depth, match):
    """The JAX CLI's refusals: no deep trunk, then a mesh without a
    'model' axis to pipeline over (the world here is one process)."""
    from automoe_tpu_torch.train.cli import main

    argv = _argv(seq_root, tmp_path, "--epochs", "1", "--pp-microbatches", "2")
    argv[argv.index("--trunk-depth") + 1] = depth
    with pytest.raises(SystemExit, match=match):
        main(argv)


def test_cli_trunk_depth_zero_builds_easy_backbone_and_gpu_is_required(monkeypatch, capsys):
    from automoe_tpu_torch.models import DeepTrajectoryPolicy, TrajectoryPolicy
    from automoe_tpu_torch.train import workloads as W
    from automoe_tpu_torch.train.cli import main

    built = []
    real = W.policy_workload

    def spy(**kw):
        wl = real(**kw)
        build = wl.build_model
        wl.build_model = lambda: built.append(build()) or built[-1]
        return wl

    monkeypatch.setattr(W, "policy_workload", spy)
    for depth, cls in (("0", TrajectoryPolicy), ("2", DeepTrajectoryPolicy)):
        assert main(["policy", "--device", "cpu", "--image-size", str(S), "--trunk-depth",
                     depth, "--trunk-width", "16"]) == {"dry_run": True}
        assert type(built[-1]) is cls
    assert "'waypoints': (2, 8, 2)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["policy", "--image-size", str(S), "--trunk-depth", "2"])
