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


@pytest.mark.parametrize("B", [1, 2])
def test_stem_kernel_at_the_closed_loops_batch(gen, B):
    """K3 bf16 at B=1 (`automoe-infer-torch --quantize`, one frame a
    control step) and B=2, full 256x256 input, O = 256: far fewer row tiles
    than the card has SMs, so most persistent blocks get none and must
    exit. Two launches back to back, each against the plain version
    (±1 on at most 0.1% of elements) and equal to each other."""
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs(gen, B, 256, 256)
    ref = stem.s2d_stem_pool_int8_plain(xs, w, bias, inv)
    outs = [stem.s2d_stem_pool_int8(xs, w, bias, inv) for _ in range(2)]
    torch.cuda.synchronize()
    for out in outs:
        assert out.shape == (B, 64, 64, 256)
        d = (out.int() - ref.int()).abs()
        assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3
    assert torch.equal(outs[0], outs[1])


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


@pytest.mark.parametrize("xs_dtype,w_dtype", [
    (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16),
])
def test_stem_kernel_rejects_bad_inputs(gen, xs_dtype, w_dtype):
    """Mixed dtypes, or one that is neither bf16 nor f32: raised before any
    launch."""
    from automoe_tpu_torch.ops import stem

    xs = torch.zeros(1, 36, 36, 12, device="cuda", dtype=xs_dtype)
    w = torch.zeros(192, 64, device="cuda", dtype=w_dtype)
    v = torch.zeros(64, device="cuda")
    n = dict(stem.LAUNCHES)
    with pytest.raises(ValueError):
        stem.s2d_stem_pool_int8(xs, w, v, v)
    assert stem.LAUNCHES == n


def _stem_inputs_f32(gen, B, H, W, O=256, mixed_sign=False):
    """_stem_inputs in float32 (xs and w not rounded to bf16); with
    mixed_sign about half of inv negative and one inv 0."""
    xs = torch.randn(B, H // 2 + 4, W // 2 + 4, 12, device="cuda", generator=gen)
    w = torch.randn(192, O, device="cuda", generator=gen) * 0.05
    bias = torch.randn(O, device="cuda", generator=gen) * 0.1
    inv = 127.0 / (torch.rand(O, device="cuda", generator=gen) * 4 + 1)
    if mixed_sign:
        inv = inv * torch.where(torch.rand(O, device="cuda", generator=gen) < 0.5, -1.0, 1.0)
        inv[7] = 0
    return xs, w, bias, inv


@pytest.mark.parametrize("B,H,W,O,mixed_sign", [
    pytest.param(8, 256, 256, 256, False, id="B8-256-positive"),
    pytest.param(8, 256, 256, 256, True, id="B8-256-mixed-sign"),
    pytest.param(32, 256, 256, 256, False, id="B32-256-positive"),
    pytest.param(32, 256, 256, 256, True, id="B32-256-mixed-sign"),
    pytest.param(2, 50, 86, 128, False, id="conv-25x43-partial-tiles"),
    pytest.param(3, 34, 18, 192, True, id="conv-17x9-O192"),
    pytest.param(1, 64, 64, 64, False, id="B1-one-expert"),
])
def test_stem_kernel_f32_matches_plain(gen, B, H, W, O, mixed_sign):
    """K3's f32 instantiation against the plain version (TF32 off, so the
    plain conv is an f32 one): the int8 outputs at most 1 apart, in at most
    1e-3 of the elements (summation order moves a round(h * inv) by one),
    as the bf16 kernel is held; launched once, under its own count."""
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs_f32(gen, B, H, W, O, mixed_sign)
    n = dict(stem.LAUNCHES)
    out = stem.s2d_stem_pool_int8(xs, w, bias, inv)
    torch.cuda.synchronize()
    assert stem.LAUNCHES["s2d_stem_pool_int8_f32"] == n["s2d_stem_pool_int8_f32"] + 1
    assert stem.LAUNCHES["s2d_stem_pool_int8"] == n["s2d_stem_pool_int8"]
    ref = stem.s2d_stem_pool_int8_plain(xs, w, bias, inv)
    assert out.shape == ref.shape and out.dtype == torch.int8
    d = (out.int() - ref.int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 1e-3
    if mixed_sign:
        assert (out[..., 7] == 0).all()


@pytest.mark.parametrize("mixed_sign", [False, True], ids=["positive", "mixed-sign"])
def test_stem_kernel_f32_holds_f32_accuracy(gen, mixed_sign):
    """K3's f32 kernel runs on the tensor cores in three TF32 passes (each
    value split as hi + lo): at B=32, 256x256, O=256 its int8 outputs are
    within ±1 of the plain version's (an f32 conv, TF32 off) on at most
    5e-5 of the elements, f32's level (one TF32 pass misses by ~8e-3)."""
    from automoe_tpu_torch.ops import stem

    xs, w, bias, inv = _stem_inputs_f32(gen, 32, 256, 256, 256, mixed_sign)
    out = stem.s2d_stem_pool_int8(xs, w, bias, inv)
    torch.cuda.synchronize()
    d = (out.int() - stem.s2d_stem_pool_int8_plain(xs, w, bias, inv).int()).abs()
    assert d.max() <= 1 and (d > 0).float().mean() <= 5e-5


def test_stem_kernel_f32_is_deterministic(gen):
    from automoe_tpu_torch.ops import stem

    args = _stem_inputs_f32(gen, 3, 256, 256, mixed_sign=True)
    first = stem.s2d_stem_pool_int8(*args)
    second = stem.s2d_stem_pool_int8(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int8_engine_f32_on_cuda_matches_cpu(gen):
    """InferenceEngine(quantize=True, dtype=float32), the engine of
    `automoe-serve-torch --quantize --fp32`: on the card its stem is K3's
    f32 kernel, once a step, and its expert weights stay within 0.05 of
    the same engine's on the CPU (the plain version), as the int8 engine is
    held against the float one."""
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.ops import stem

    frames = np.random.default_rng(1).integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
    kw = dict(camera_hw=(96, 128), model_hw=(64, 64), dtype=torch.float32, quantize=True)
    want = InferenceEngine(default_model_config(), device="cpu", **kw).infer_batch(
        frames, np.ones(2))
    eng = InferenceEngine(default_model_config(), device="cuda", **kw)
    stem.reset_launch_counts()
    got = eng.infer_batch(frames, np.ones(2))
    assert stem.LAUNCHES == {"s2d_stem_pool_int8": 0, "s2d_stem_pool_int8_f32": 1,
                             "maxpool3x3s2_int8": 0}
    assert np.isfinite(got["waypoints"]).all()
    np.testing.assert_allclose(got["expert_weights"], want["expert_weights"], atol=0.05)


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


@pytest.mark.parametrize("regime", ["nuscenes-diverse", "nuscenes-degenerate",
                                    "nuscenes-2d-jv", "nuscenes-untrained",
                                    "nuscenes-negative-sizes"])
def test_auction_kernel_at_nuscenes_shapes(gen, regime):
    """K1+K2 at the nuScenes trainers' shapes (B=32, N=48, Q=100 on 7-dim
    boxes: the 4-columns-per-lane instantiation; costs up to ~1e10 with
    negative sizes) and K2 alone at the 2D fine-tune's (B=16, N=48, Q=196,
    max_iters=0: 8 columns per lane): identical to the plain version, and
    optimal in cost within float32's rounding of it (scipy_gap_limit)."""
    from scipy.optimize import linear_sum_assignment

    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.bench_auction import nuscenes_regimes, scipy_gap_limit

    _, benefit, valid, eps, max_iters = {r[0]: r for r in nuscenes_regimes(gen)}[regime]
    out = ak.auction_solve(benefit, valid, eps, max_iters=max_iters)
    torch.cuda.synchronize()
    masked = torch.where(valid[..., None], benefit, torch.zeros_like(benefit))
    assert torch.equal(out, ak.auction_solve_plain(masked, valid, eps, max_iters=max_iters))
    cost, o, v = (-benefit).double().cpu().numpy(), out.cpu().numpy(), valid.cpu().numpy()
    for b in range(cost.shape[0]):
        sub = cost[b][v[b]]
        ri, ci = linear_sum_assignment(sub)
        opt = sub[ri, ci].sum()
        assert abs(sub[np.arange(len(sub)), o[b][v[b]]].sum() - opt) <= scipy_gap_limit(opt)


def test_nuscenes_step_cuda_matches_cpu(gen):
    """Two SGD steps of the LiDAR nuScenes workload (TNets, concat; K1 on
    the card, its plain version on the CPU), dropout off, TF32 off, one
    seed's weights, batches whose matches have no near-tie: losses within
    rtol 1e-4, parameters and BatchNorm statistics within rtol 1e-3 / atol
    1e-5."""
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import nuscenes_batch
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import nuscenes_workload

    rng = np.random.default_rng(5)
    batches = [nuscenes_batch(rng, 8, size=64, points=256, nbox=4) for _ in range(2)]
    wl = nuscenes_workload(num_queries=16, use_lidar=True, use_tnet=True, fusion="concat",
                           matcher="auction_kernel")
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(0, torch.device(dev))
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, weight_decay=0.0,
                             total_steps=2, optimizer="sgd")
        step = make_train_step(wl.loss_fn)
        n = ak.LAUNCHES["auction_solve"]
        losses = [float(step(model, opt, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
                        ["loss"]) for b in batches]
        runs[dev] = (losses, model.state_dict(), ak.LAUNCHES["auction_solve"] - n)
    assert runs["cuda"][2] == 2 and runs["cpu"][2] == 0
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][1].items():
        if v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].cpu().numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


class _Replay(torch.nn.Module):
    """A stand-in expert on the CPU that returns recorded outputs in turn."""

    def __init__(self, outs):
        super().__init__()
        self.outs = iter(outs)
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def forward(self, image, lidar):
        return next(self.outs)


def test_evaluate_nuscenes_on_cuda_matches_cpu(gen):
    """evaluate_nuscenes of a LiDAR expert on the card matches exactly on
    the card (K2 alone, one launch per batch, no host solver) and gives the
    val loss that the CPU's scipy match gives on the same expert outputs:
    rtol 1e-5. Batch seed 15: each element's best assignment beats its
    second best by >= 1e-2 in cost (~300 float32 ulps), so the two
    devices' roundings of the costs cannot flip a match."""
    from automoe_tpu_torch.evals.nuscenes import evaluate_nuscenes
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import nuscenes_batch
    from automoe_tpu_torch.train.workloads import nuscenes_workload

    rng = np.random.default_rng(15)
    batches = []
    for _ in range(3):
        b = nuscenes_batch(rng, 4, size=64, points=256, nbox=4)
        b["boxes"][..., 3:6] = np.abs(b["boxes"][..., 3:6]) + 0.5  # real boxes' sizes
        batches.append(b)
    model = nuscenes_workload(num_queries=16, use_lidar=True, use_tnet=True,
                              fusion="concat").init_model(0, torch.device("cuda"))
    outs = []
    model.register_forward_hook(
        lambda m, i, o: outs.append({k: v.detach().cpu() for k, v in o.items()}))
    n = ak.LAUNCHES["auction_solve"]
    got = evaluate_nuscenes(model, batches)
    assert ak.LAUNCHES["auction_solve"] - n == len(batches)
    want = evaluate_nuscenes(_Replay(outs), batches)
    assert ak.LAUNCHES["auction_solve"] - n == len(batches)  # the CPU ran scipy
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)


@pytest.mark.parametrize("cmd", [["bdd", "--task", "segmentation"],
                                 ["finetune-carla", "--task", "drivable"], ["nuscenes-2d"]])
def test_seg_and_2d_train_cli_on_cuda(gen, tmp_path, cmd):
    """Segmentation and drivable training launch no kernel; the nuScenes
    2D fine-tune launches K2 alone once per train and val step."""
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools import synth
    from automoe_tpu_torch.train.cli import main

    n_split = {"train": 4, "val": 3}
    if cmd[0] == "bdd":
        root = synth.synth_bdd_segmentation(tmp_path / "d", n_per_split=n_split, size=64)
    elif cmd[0] == "finetune-carla":
        root = synth.synth_carla_segmentation(tmp_path / "d", n_per_split=n_split, size=64)
    else:
        root = synth.synth_carla_detection(tmp_path / "d", n_per_split=n_split, size=64,
                                           max_boxes=3)
        cmd = cmd + ["--num-queries", "16", "--box-cap", "4"]
    n = ak.LAUNCHES["auction_solve"]
    res = main(cmd + ["--data-root", str(root), "--image-size", "64", "--batch-size", "2",
                      "--epochs", "1", "--num-workers", "1", "--runs-root",
                      str(tmp_path / "runs"), "--ckpt-root", str(tmp_path / "ckpt")])
    # 2 train steps + 2 val steps (the second a padded tail)
    assert ak.LAUNCHES["auction_solve"] - n == (4 if cmd[0] == "nuscenes-2d" else 0)
    assert np.isfinite(res["best_val_loss"]) and res["device_timed"] == 1.0


class _TinyNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(4)
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3)))


def _tiny_loss(model, batch, train, key=None):
    logits = model(batch["image"].permute(0, 3, 1, 2))
    return torch.nn.functional.cross_entropy(logits, batch["label"]), {}


def test_resident_groups_are_cuda_tensors_without_pinned_copies(gen, tmp_path, monkeypatch):
    """The device-resident loader yields [K,B,...] groups on the card, and
    the Trainer's pre-grouped path hands them to its K-step call as they
    are: no pinned host copy, no transfer."""
    from automoe_tpu_torch.data.device_resident import DeviceEpochLoader
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import Workload

    rng = np.random.default_rng(0)
    arrays = {"image": rng.normal(size=(24, 8, 8, 3)).astype(np.float32),
              "label": rng.integers(0, 3, 24)}
    loader = DeviceEpochLoader(arrays, batch_size=4, group_size=3, seed=1)
    groups = list(loader)
    assert len(groups) == 2 and len(loader) == 6
    assert all(v.is_cuda and v.shape[:2] == (3, 4) for g in groups for v in g.values())
    trainer = Trainer(Workload("tiny", _TinyNet, _tiny_loss), loader,
                      [{k: v[:4] for k, v in arrays.items()}],
                      TrainConfig(epochs=1, steps_per_call=3, ckpt_root=str(tmp_path / "ck"),
                                  runs_root=str(tmp_path / "runs")))
    placed = trainer._device_batch(groups[0])
    assert all(placed[k].data_ptr() == groups[0][k].data_ptr() for k in placed)

    def no_pin(self, *a, **k):
        raise AssertionError("a resident batch took a pinned copy")

    monkeypatch.setattr(torch.Tensor, "pin_memory", no_pin)
    loss = trainer.train_epoch(0)
    assert np.isfinite(loss) and trainer.optimizer.count == 6


def test_cached_gating_step_on_cuda_matches_cpu(gen):
    """The cached gating step (pooled features computed on each device from
    the same weights) on the card against the CPU, TF32 off, dropout off,
    two SGD steps: loss rtol 1e-4, parameters rtol 1e-3 / atol 1e-5; the experts untouched."""
    from automoe_tpu_torch.models import automoe_pooled_features
    from automoe_tpu_torch.train.feature_cache import pooled_keys
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import gating_workload

    cfg = {"experts": [{"type": "detection", "num_classes": 10},
                       {"type": "segmentation", "num_classes": 19},
                       {"type": "drivable", "num_classes": 3},
                       {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
                        "use_lidar": False}],
           "policy": {"num_waypoints": 4}}
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
             "speed": rng.uniform(0, 30, (4, 4)).astype(np.float32),
             "steering": rng.normal(0, 0.2, (4, 4)).astype(np.float32),
             "throttle": rng.uniform(0, 1, (4, 4)).astype(np.float32),
             "brake": np.zeros((4, 4), np.float32),
             "waypoints": rng.normal(0, 3, (4, 4, 2)).astype(np.float32)}
    wl = gating_workload(cfg, cache_features=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = wl.init_model(0, torch.device(dev))
        for m in model.modules():  # the card's and the CPU's dropout masks differ
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        b.update(zip(pooled_keys(4), automoe_pooled_features(model, b)))
        # SGD: AdamW would turn the ~1e-8 noise gradients of the conv biases
        # ahead of BatchNorm into ±lr steps of either sign
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-2, weight_decay=0.0,
                             total_steps=4, optimizer="sgd",
                             trainable_mask=wl.trainable_mask(model))
        step = make_train_step(wl.loss_fn)
        losses = [float(step(model, opt, b, (1, i))["loss"]) for i in range(2)]
        runs[dev] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     start)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for k, v in runs["cpu"][1].items():
        if k.startswith("experts."):
            assert torch.equal(runs["cuda"][1][k], runs["cuda"][2][k]), k
        elif v.is_floating_point():
            np.testing.assert_allclose(runs["cuda"][1][k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)


def test_eval_cli_bdd_detection_on_cuda_matches_cpu(gen, tmp_path):
    """`automoe-eval-torch bdd --task detection` on the card against
    --device cpu (TF32 off): val_loss rtol 1e-4, avg_iou / recall_0.5 atol
    1e-5, with K2 alone (the exact 'hungarian' match) launched once per
    batch on the card and never on the CPU. The expert is seed 0 with its
    box channels moved to pixel boxes inside the image; its matches on
    these frames survive 3e-5 relative noise (30 draws a batch)."""
    from automoe_tpu_torch.evals.cli import main
    from automoe_tpu_torch.ops import auction_kernel as ak
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    root = synth_carla_detection(tmp_path / "det", n_per_split={"val": 6}, size=64,
                                 max_boxes=4, seed=0)
    model = bdd_expert_workload("detection").init_model(0, "cpu")
    with torch.no_grad():
        model.head[2].weight[10:] *= 8
        model.head[2].bias[10:] = torch.tensor([32.0, 32.0, 20.0, 20.0])
    ckpt = tmp_path / "det.pt"
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    argv = ["bdd", "--task", "detection", "--source", "carla", "--data-root", str(root),
            "--checkpoint", str(ckpt), "--batch-size", "3", "--num-workers", "1",
            "--box-cap", "4"]
    res = {}
    for device in ("cuda", "cpu"):
        ak.reset_launch_counts()
        res[device] = main(argv + ["--device", device, "--out-dir", str(tmp_path / device)])
        res[device + "_launches"] = ak.LAUNCHES["auction_solve"]
    assert (res["cuda_launches"], res["cpu_launches"]) == (2, 0)
    np.testing.assert_allclose(res["cuda"]["val_loss"], res["cpu"]["val_loss"], rtol=1e-4)
    for k in ("avg_iou", "recall_0.5"):
        np.testing.assert_allclose(res["cuda"][k], res["cpu"][k], atol=1e-5, err_msg=k)
    assert res["cpu"]["avg_iou"] > 0


# ---------------------------------------------------------------------------
# the closed loop and the model options a served config reaches
# ---------------------------------------------------------------------------

TINY = {
    "experts": [
        {"type": "drivable", "num_classes": 3},
        {"type": "nuscenes", "num_queries": 8, "bbox_dim": 4, "fusion": "sum",
         "use_lidar": False},
    ],
    "gating": {"top_k": 0, "noise_scale": 0.0},
    "context": {"type": "simple"},
    "policy": {"num_waypoints": 4},
}


def test_closed_loop_f32_on_cuda_matches_cpu(gen):
    """run_closed_loop over MockSim with an f32 engine (the tiny config,
    camera 120x160, model 64x64, 12 steps, TF32 off) on the card against
    the CPU: steer, throttle, brake and speed within atol 1e-4, expert
    weights within 1e-5 (the CPU tests' bounds against JAX)."""
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.infer.run_automoe import run_closed_loop
    from automoe_tpu_torch.infer.sim import MockSim

    logs = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine(TINY, camera_hw=(120, 160), model_hw=(64, 64),
                              dtype=torch.float32, device=device, seed=3)
        logs[device] = run_closed_loop(eng, MockSim(camera_hw=(120, 160), seed=2), steps=12)
    for g, w in zip(logs["cuda"], logs["cpu"]):
        for k in ("steer", "throttle", "brake", "speed_kmh"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-4, err_msg=(g["step"], k))
        np.testing.assert_allclose(g["expert_weights"], w["expert_weights"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("trunk,stem_kind", [("v1", "s2d"), ("q8", "fused"), ("q8", "solo")])
def test_int8_trunks_and_stems_on_cuda_match_cpu(gen, trunk, stem_kind):
    """make_quant_forward with trunk "v1" and the "fused" and "solo" stems
    (torch convs: no stem kernel launches) on the card against the CPU on
    one quantized pack, f32, TF32 off: waypoint relative error < 0.03 and
    expert weights within 0.05, the int8 engine's bounds."""
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.models import create_automoe_model
    from automoe_tpu_torch.ops import stem
    from automoe_tpu_torch.serving.quant import (
        make_quant_forward,
        prepare_qexperts,
        quantize_automoe,
    )

    cfg = default_model_config()
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    speed = torch.from_numpy(rng.uniform(0, 30, (4, 1)).astype(np.float32))
    model = create_automoe_model(cfg, fast_gating_pool=True, device="cpu", seed=1)
    pack = quantize_automoe(model, [{"image": image}], dtype=torch.float32)
    fwd = make_quant_forward(cfg, pack["scales"], dtype=torch.float32, trunk=trunk,
                             stem=stem_kind)
    out = {}
    for device in ("cpu", "cuda"):
        m = model.to(device)
        q = prepare_qexperts(pack, torch.float32, device, trunk=trunk, stem=stem_kind)
        stem.reset_launch_counts()
        out[device] = {k: v.cpu().numpy() for k, v in fwd(
            m, q, {"image": image.to(device), "speed": speed.to(device)}).items()}
        assert not any(stem.LAUNCHES.values()), stem.LAUNCHES
    w = out["cpu"]["waypoints"]
    assert np.isfinite(out["cuda"]["waypoints"]).all()
    assert np.abs(out["cuda"]["waypoints"] - w).mean() / np.abs(w).mean() < 0.03
    np.testing.assert_allclose(out["cuda"]["expert_weights"], out["cpu"]["expert_weights"],
                               atol=0.05)


def test_full_context_topk_automoe_on_cuda_matches_cpu(gen):
    """AutoMoE with context 'full' and top-2 routing honoured at eval
    (apply_topk_at_eval), f32, TF32 off, B=8: card against CPU at rtol 1e-3 /
    atol 1e-4; then its gating network in train mode with routing noise
    (scale 1) from one CPU generator seed on each device: the same experts
    chosen."""
    import dataclasses

    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.models import create_automoe_model

    cfg = default_model_config()
    cfg = dataclasses.replace(
        cfg, context=dataclasses.replace(cfg.context, type="full"),
        gating=dataclasses.replace(cfg.gating, honor_topk_in_composite=True))
    rng = np.random.default_rng(4)

    def col(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, (8, 1)).astype(np.float32))

    batch = {"image": torch.from_numpy(rng.normal(size=(8, 64, 64, 3)).astype(np.float32)),
             "speed": col(0, 30), "hour": col(0, 24), "minute": col(0, 60),
             "weather": {"rain": col(0, 1), "fog": col(0, 1)},
             "road": {"curvature": col(-0.1, 0.1)}}
    feats = [torch.from_numpy(rng.normal(size=(8, e.output_dim)).astype(np.float32))
             for e in cfg.experts]
    ctx = torch.from_numpy(rng.normal(size=(8, cfg.context.context_dim)).astype(np.float32))
    model = create_automoe_model(cfg, fast_gating_pool=True, device="cpu", seed=2)
    out = {}
    for device in ("cpu", "cuda"):
        m = model.to(device).eval()
        b = {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict)
                 else v.to(device)) for k, v in batch.items()}
        g = m.gating_network
        with torch.no_grad():
            det = m(b)
            g.noise_scale = 1.0
            g.train()
            for mod in g.modules():
                if isinstance(mod, torch.nn.Dropout):
                    mod.eval()
            noisy = g([f.to(device) for f in feats], ctx.to(device),
                      generator=torch.Generator().manual_seed(5))
            g.noise_scale = 0.0
        out[device] = (det, noisy)
    for k in ("waypoints", "expert_weights", "combined_features", "context_features"):
        np.testing.assert_allclose(out["cuda"][0][k].cpu().numpy(),
                                   out["cpu"][0][k].numpy(), rtol=1e-3, atol=1e-4, err_msg=k)
    assert ((out["cuda"][0]["expert_weights"] > 0).sum(-1) == 2).all()
    chosen = [(o[1]["expert_weights"] > 0).cpu() for o in (out["cuda"], out["cpu"])]
    assert torch.equal(chosen[0], chosen[1])
