"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: each test skips where no GPU is present. On a GPU
machine without JAX, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _stem_inputs(gen, B, H, W, O=256, zero_inv=False):
    """s2d input for an HxW image, [192,O] weights, bias and inv on the card;
    with zero_inv every third inv is 0."""
    xs = torch.randn(B, H // 2 + 4, W // 2 + 4, 12, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(192, O, device="cuda", generator=gen) * 0.05).bfloat16()
    bias = torch.randn(O, device="cuda", generator=gen) * 0.1
    inv = 127.0 / (torch.rand(O, device="cuda", generator=gen) * 4 + 1)
    if zero_inv:
        inv[::3] = 0
    return xs, w, bias, inv


@pytest.mark.parametrize("B,H,W,O,zero_inv", [
    pytest.param(2, 64, 64, 256, False, id="2-64-64"),
    pytest.param(3, 40, 72, 256, False, id="3-40-72"),
    pytest.param(1, 64, 64, 64, False, id="B1-one-expert"),
    pytest.param(2, 50, 86, 128, False, id="conv-25x43-not-tile-multiples"),
    pytest.param(2, 34, 18, 192, False, id="conv-17x9-O192"),
    pytest.param(1, 256, 256, 256, False, id="B1-full-132x132"),
    pytest.param(3, 256, 256, 64, False, id="full-192-tiles-blocks-loop"),
    pytest.param(3, 256, 256, 256, False, id="full-O256-blocks-loop"),
    pytest.param(2, 64, 64, 320, False, id="O320-two-channel-groups"),
    pytest.param(2, 64, 64, 256, True, id="zero-inv"),
])
def test_stem_kernel_matches_plain(gen, B, H, W, O, zero_inv):
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs(gen, B, H, W, O, zero_inv)
    n = stem.LAUNCHES["s2d_stem_pool_int8"]
    out = stem.s2d_stem_pool_int8(xs, w, bias, inv)
    torch.cuda.synchronize()
    assert stem.LAUNCHES["s2d_stem_pool_int8"] == n + 1
    d = (out.int() - stem.s2d_stem_pool_int8_plain(xs, w, bias, inv).int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3


def test_stem_kernel_matches_plain_mixed_sign_inv(gen):
    """About half the channels with a negative inv, one with inv = 0: the
    kernel negates the pooled bytes of the negative channels, which gives
    the plain version's q(max h * inv); same tolerance as above."""
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs(gen, 8, 256, 256)
    sign = torch.where(torch.rand(256, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
    inv = inv * sign
    inv[7] = 0
    out = stem.s2d_stem_pool_int8(xs, w, bias, inv)
    torch.cuda.synchronize()
    ref = stem.s2d_stem_pool_int8_plain(xs, w, bias, inv)
    d = (out.int() - ref.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3
    assert out[..., inv < 0].max() <= 0 < out[..., inv > 0].max()
    assert (out[..., 7] == 0).all()


def test_stem_kernel_is_deterministic(gen):
    """Two calls in one process give identical outputs: the shared-memory
    opt-in is taken once and the persistent loop's order is fixed."""
    from automoe_tpu_torch.ops import stem

    args = _stem_inputs(gen, 3, 256, 256)
    first = stem.s2d_stem_pool_int8(*args)
    second = stem.s2d_stem_pool_int8(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("shape", [(2, 32, 32, 128), (3, 33, 17, 32)])
def test_pool_kernel_matches_plain(gen, shape):
    from automoe_tpu_torch.ops import stem

    x = torch.randint(-128, 128, shape, device="cuda", dtype=torch.int8, generator=gen)
    out = stem.maxpool3x3s2_int8(x)
    torch.cuda.synchronize()
    assert torch.equal(out, stem.maxpool3x3s2_int8_plain(x))


def test_stem_kernel_rejects_bad_inputs(gen):
    from automoe_tpu_torch.ops import stem

    xs = torch.zeros(1, 36, 36, 12, device="cuda")  # f32, not bf16
    w = torch.zeros(192, 64, device="cuda", dtype=torch.bfloat16)
    v = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError):
        stem.s2d_stem_pool_int8(xs, w, v, v)


@pytest.mark.parametrize("variant", ["fused", "pool"])
def test_int8_engine_on_cuda(gen, variant):
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine

    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    kw = dict(camera_hw=(96, 128), model_hw=(64, 64), device="cuda")
    ref = InferenceEngine(default_model_config(), **kw).infer_batch(frames, np.ones(2))
    out = InferenceEngine(default_model_config(), quantize=True, stem_variant=variant,
                          **kw).infer_batch(frames, np.ones(2))
    assert np.isfinite(out["waypoints"]).all()
    np.testing.assert_allclose(out["expert_weights"], ref["expert_weights"], atol=0.05)


def _auction_inputs(B, N, Q, regime, seed=0):
    """benefit [B,N,Q], valid [B,N], eps [B] on the card: random costs, the
    clustered predictions of an untrained detector (near-ties), or column
    ties (every row sees the same best benefit on 8 columns)."""
    from automoe_tpu_torch.ops.matching import match_cost_matrix

    rng = np.random.default_rng(seed)
    if regime == "degenerate":
        C = 10
        logits = rng.normal(size=(1, 1, C)) + 1e-3 * rng.normal(size=(B, Q, C))
        boxes = np.clip(np.array([0.4, 0.4, 0.6, 0.6]) + 1e-3 * rng.normal(size=(B, Q, 4)), 0, 1)
        tb = rng.uniform(0.1, 0.9, (B, N, 4))
        tl = rng.integers(0, C, (B, N))
        cost = match_cost_matrix(*(torch.tensor(a, dtype=torch.float32, device="cuda")
                                   for a in (logits, boxes, tb)),
                                 torch.tensor(tl, device="cuda"))
        benefit = -cost.transpose(1, 2).contiguous()
    elif regime == "ties":
        b = -rng.integers(1, 4, (B, N, Q)).astype(np.float32)
        b[:, :, rng.choice(Q, 8, replace=False)] = -0.5
        benefit = torch.tensor(b, device="cuda")
    else:
        benefit = -torch.tensor(rng.uniform(0, 10, (B, N, Q)), dtype=torch.float32,
                                device="cuda")
    valid = torch.ones(B, N, dtype=torch.bool, device="cuda")
    valid[0, N // 2:] = False
    valid[-1] = B < 3  # one whole element invalid when B >= 3
    spread = (benefit.amax((1, 2)) - benefit.amin((1, 2))).clamp(min=1e-3)
    return benefit, valid, spread * 1e-6 / N


@pytest.mark.parametrize("B,N,Q,regime,max_iters", [
    (4, 48, 64, "random", 128),
    (4, 48, 64, "degenerate", 128),
    (3, 48, 64, "random", 0),
    (2, 64, 256, "random", 128),  # 512^2 images: above 48 KB of shared memory
    (3, 12, 20, "degenerate", 5),
    (2, 3, 40, "random", 1000),
    (3, 48, 100, "random", 128),  # Q not a multiple of 32
    (2, 24, 196, "degenerate", 128),
    (3, 70, 40, "random", 128),  # N > Q: rows left unassigned
    (3, 80, 50, "degenerate", 5),
    (4, 48, 64, "ties", 0),
    (4, 48, 64, "ties", 5),
    (4, 48, 64, "ties", 128),
    (2, 16, 128, "ties", 0),  # JV's register path at its widest per-lane count but one
    (2, 20, 300, "random", 0),  # Q > 256: JV with its state in shared memory
    (2, 12, 300, "degenerate", 128),
])
def test_auction_kernel_matches_plain(gen, B, N, Q, regime, max_iters):
    from automoe_tpu_torch.ops import auction_kernel as ak

    benefit, valid, eps = _auction_inputs(B, N, Q, regime)
    n = ak.LAUNCHES["auction_solve"]
    out = ak.auction_solve(benefit, valid, eps, max_iters=max_iters)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["auction_solve"] == n + 1
    masked = torch.where(valid[..., None], benefit, torch.zeros_like(benefit))
    ref = ak.auction_solve_plain(masked, valid, eps, max_iters=max_iters)
    assert torch.equal(out, ref)
    assert (out[~valid] == -1).all()


@pytest.mark.parametrize("B,N,Q,regime,max_iters", [
    (4, 48, 64, "degenerate", 5),
    (3, 48, 100, "ties", 2),
    (3, 70, 40, "random", 3),
])
def test_auction_kernel_greedy_matches_plain(gen, B, N, Q, regime, max_iters):
    """escalate=False: the greedy completion in place of JV."""
    from automoe_tpu_torch.ops import auction_kernel as ak

    benefit, valid, eps = _auction_inputs(B, N, Q, regime)
    out = ak.auction_solve(benefit, valid, eps, max_iters=max_iters, escalate=False)
    torch.cuda.synchronize()
    masked = torch.where(valid[..., None], benefit, torch.zeros_like(benefit))
    assert torch.equal(out, ak.auction_solve_plain(masked, valid, eps, max_iters=max_iters,
                                                   escalate=False))


def test_auction_kernel_is_deterministic(gen):
    """Two calls give identical outputs, though the bids' atomics land in
    another order."""
    from automoe_tpu_torch.ops import auction_kernel as ak

    benefit, valid, eps = _auction_inputs(32, 48, 64, "degenerate", seed=3)
    first = ak.auction_solve(benefit, valid, eps, max_iters=128)
    second = ak.auction_solve(benefit, valid, eps, max_iters=128)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_auction_kernel_rejects_oversized(gen):
    from automoe_tpu_torch.ops import auction_kernel as ak

    benefit = torch.zeros(1, 256, 256, device="cuda")
    valid = torch.ones(1, 256, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        ak.auction_solve(benefit, valid, torch.ones(1, device="cuda"))


def test_detection_train_step_cuda_matches_cpu(gen):
    """Two SGD steps of the detection workload (auction_kernel: K1 on the
    card, its plain version on the CPU), f32 without TF32, same weights:
    losses within rtol 1e-4, parameters within rtol 1e-3 / atol 1e-5."""
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "bboxes": np.concatenate([rng.uniform(0.05, 0.45, (2, 4, 2)),
                                       rng.uniform(0.55, 0.95, (2, 4, 2))], -1).astype(np.float32),
             "labels": rng.integers(0, 10, (2, 4)).astype(np.int32)}
    wl = bdd_expert_workload("detection", matcher="auction_kernel")
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(0, torch.device(dev))
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, weight_decay=0.0,
                             total_steps=2, optimizer="sgd")
        step = make_train_step(wl.loss_fn)
        n = ak.LAUNCHES["auction_solve"]
        losses = [float(step(model, opt, {k: torch.from_numpy(v).to(dev)
                                          for k, v in batch.items()})["loss"])
                  for _ in range(2)]
        runs[dev] = (losses, model.state_dict(), ak.LAUNCHES["auction_solve"] - n)
    assert runs["cuda"][2] == 2 and runs["cpu"][2] == 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].cpu().numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_train_cli_on_cuda_launches_k1_per_step(gen, tmp_path):
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import main

    root = synth_carla_detection(tmp_path / "data", n_per_split={"train": 4, "val": 3},
                                 size=64, max_boxes=3)
    n = ak.LAUNCHES["auction_solve"]
    res = main(["finetune-carla", "--task", "detection", "--data-root", str(root),
                "--image-size", "64", "--box-cap", "4", "--batch-size", "2", "--epochs", "2",
                "--num-workers", "1", "--runs-root", str(tmp_path / "runs"),
                "--ckpt-root", str(tmp_path / "ckpt")])
    # 2 epochs x (2 train steps + 2 val steps, the second a padded tail)
    assert ak.LAUNCHES["auction_solve"] - n == 8
    assert np.isfinite(res["best_val_loss"]) and res["device_timed"] == 1.0


def test_resume_on_cuda(gen, tmp_path):
    """finetune-carla for 1 epoch with checkpoints on the card, then
    --resume full to 2 epochs: K1 launches for epoch 2's steps only, and
    the step count continues."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train import cli

    root = synth_carla_detection(tmp_path / "data", n_per_split={"train": 4, "val": 2},
                                 size=64, max_boxes=3)
    argv = ["finetune-carla", "--task", "detection", "--data-root", str(root),
            "--image-size", "64", "--box-cap", "4", "--batch-size", "2", "--num-workers", "1",
            "--runs-root", str(tmp_path / "runs"), "--ckpt-root", str(tmp_path / "ckpt")]
    cli.main(argv + ["--epochs", "1"])
    last = load_checkpoint(tmp_path / "ckpt" / "bdd_detection" / "run" / "last.pt")
    assert (last["epoch"], last["step"]) == (0, 2)

    n = ak.LAUNCHES["auction_solve"]
    res = cli.main(argv + ["--epochs", "2", "--resume", "full"])
    # epoch 2 only: 2 train steps + 1 val step
    assert ak.LAUNCHES["auction_solve"] - n == 3 and np.isfinite(res["best_val_loss"])
    last2 = load_checkpoint(tmp_path / "ckpt" / "bdd_detection" / "run" / "last.pt")
    assert (last2["epoch"], last2["step"]) == (1, 4)


def test_restore_on_cuda_equals_the_file(gen, tmp_path):
    """A `full` restore onto the card reproduces the checkpoint exactly:
    weights, BatchNorm statistics, optimizer moments and count."""
    from automoe_tpu_torch.ckpt import CheckpointManager, load_checkpoint
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.workloads import policy_workload

    wl = policy_workload(horizon=4)
    model = wl.init_model(1, torch.device("cuda"))
    opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, total_steps=2)
    out = model(torch.randn(2, 3, 64, 64, device="cuda", generator=gen))
    (out["waypoints"].sum() + out["speed"].sum()).backward()
    opt.step()
    mgr = CheckpointManager(str(tmp_path), wl.name, "r", async_save=True)
    mgr.save_epoch(model, opt, 0, 1.0)
    other = wl.init_model(2, torch.device("cuda"))
    opt2 = make_optimizer(other.named_parameters(), learning_rate=1e-3, total_steps=2)
    assert mgr.restore(other, opt2, which="last", mode="full") == (0, 0)
    payload = load_checkpoint(mgr.path("last"))
    for k, v in other.state_dict().items():
        assert v.device.type == "cuda" and torch.equal(v.cpu(), payload["model_state_dict"][k]), k
    assert opt2.count == opt.count == 1
    for n, (mu, nu) in opt.state.items():
        assert torch.equal(opt2.state[n][0], mu) and torch.equal(opt2.state[n][1], nu), n


def test_gating_step_cuda_matches_cpu(gen):
    """One SGD gating step over a small AutoMoE, card against CPU, same
    weights, dropout off, TF32 off: loss within rtol 1e-4; parameters and
    BatchNorm running statistics within rtol 1e-3 / atol 1e-5; expert
    parameters unchanged on both."""
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import gating_workload

    cfg = {"experts": [{"type": "detection", "num_classes": 10},
                       {"type": "segmentation", "num_classes": 19},
                       {"type": "drivable", "num_classes": 3},
                       {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum"}],
           "gating": {"top_k": 0, "noise_scale": 0.0}, "context": {"type": "simple"},
           "policy": {"num_waypoints": 4}}
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             "speed": rng.uniform(0, 30, (2, 4)).astype(np.float32),
             "steering": rng.normal(size=(2, 4)).astype(np.float32) * 0.2,
             "throttle": rng.uniform(0, 1, (2, 4)).astype(np.float32),
             "brake": np.zeros((2, 4), np.float32),
             "waypoints": rng.normal(size=(2, 4, 2)).astype(np.float32)}
    wl = gating_workload(cfg)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(0, torch.device(dev))
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-2, weight_decay=0.0,
                             total_steps=1, optimizer="sgd",
                             trainable_mask=wl.trainable_mask(model))
        loss = make_train_step(wl.loss_fn)(model, opt, {k: torch.from_numpy(v).to(dev)
                                                        for k, v in batch.items()})["loss"]
        runs[dev] = (float(loss), {k: v.detach().cpu() for k, v in model.state_dict().items()})
        same = {k: torch.equal(v.detach().cpu(), before[k]) for k, v in model.named_parameters()}
        assert all(v for k, v in same.items() if k.startswith("experts."))
        # (a conv bias ahead of train-mode BatchNorm has a zero gradient)
        assert not all(v for k, v in same.items() if not k.startswith("experts."))
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
