"""The port's training-step options against the JAX package on the CPU:
augmentation (ops/augment.py) on shared parameters, fake-quant and the
QAT forward (ops/fake_quant.py, models/resnet.py), remat, gradient
accumulation, steps per call and the in-flight bound (train/step.py,
train/loop.py), the EMA (train/state.py) with its checkpoint and serving
semantics, bf16 compute at tests/test_bf16.py's bars, and one
`automoe-train-torch` run with the options together.

Sizes are small: 64 px drivable experts (B=2 a microbatch) where JAX is
compared, 32 px where only the port runs. The JAX side runs with
jax_default_matmul_precision=highest (tests/conftest.py); its drivable
workload is built once per module."""
from __future__ import annotations

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms, nchw

from tests.torch_port_common import tmp_path  # noqa: F401  (removes what tests write)
HW = 64


def _port_params(B, scale=1.0, off_y=0.0, off_x=0.0, flip=False):
    f = lambda v: torch.full((B,), v, dtype=torch.float32)  # noqa: E731
    return {"scale": f(scale), "off_y": f(off_y), "off_x": f(off_x),
            "flip": torch.full((B,), flip, dtype=torch.bool),
            "brightness": f(1.0), "contrast": f(1.0), "saturation": f(1.0)}


def _random_params(rng, B):
    return {"scale": rng.uniform(0.6, 1.0, B).astype(np.float32),
            "off_y": rng.uniform(0, 1, B).astype(np.float32),
            "off_x": rng.uniform(0, 1, B).astype(np.float32),
            "flip": rng.uniform(0, 1, B) < 0.5,
            "brightness": rng.uniform(0.8, 1.2, B).astype(np.float32),
            "contrast": rng.uniform(0.8, 1.2, B).astype(np.float32),
            "saturation": rng.uniform(0.8, 1.2, B).astype(np.float32)}


def _drivable_batch(seed, b=2, hw=HW):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(b, hw, hw, 3)).astype(np.float32),
            "mask": rng.integers(0, 3, (b, hw, hw)).astype(np.int32)}


def _detection_batch(seed, b=2, hw=32, nbox=3):
    rng = np.random.default_rng(seed)
    xy1 = rng.uniform(0.05, 0.45, (b, nbox, 2)) * hw
    xy2 = rng.uniform(0.55, 0.95, (b, nbox, 2)) * hw
    labels = rng.integers(0, 10, (b, nbox)).astype(np.int32)
    labels[0, -1] = -1
    return {"image": rng.normal(size=(b, hw, hw, 3)).astype(np.float32),
            "bboxes": np.concatenate([xy1, xy2], -1).astype(np.float32), "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_states_equal(a, b, rtol=0.0, atol=0.0):
    assert set(a) == set(b)
    for k in a:
        if rtol == atol == 0.0:
            assert torch.equal(a[k], b[k]), k
        else:
            np.testing.assert_allclose(a[k].double().numpy(), b[k].double().numpy(),
                                       rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------

def test_augment_identity_params_are_noop():
    from automoe_tpu_torch.ops.augment import AugmentConfig, augment_detection

    rng = np.random.default_rng(0)
    batch = _t({"image": rng.normal(size=(2, 16, 16, 3)).astype(np.float32),
                "bboxes": np.array([[[2, 3, 10, 12], [0, 0, 0, 0]]] * 2, np.float32),
                "labels": np.array([[3, -1]] * 2, np.int32)})
    out = augment_detection(batch, _port_params(2), AugmentConfig())
    np.testing.assert_allclose(out["image"].numpy(), batch["image"].numpy(), atol=1e-6)
    np.testing.assert_allclose(out["bboxes"].numpy(), batch["bboxes"].numpy(), atol=1e-5)
    assert torch.equal(out["labels"], batch["labels"])


def test_augment_hflip_involution():
    from automoe_tpu_torch.ops.augment import augment_images, transform_boxes

    img = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 8, 12, 3)).astype(np.float32))
    p = _port_params(2, flip=True)
    twice = augment_images(augment_images(img, p, color=False), p, color=False)
    np.testing.assert_allclose(twice.numpy(), img.numpy(), atol=1e-6)
    boxes = torch.tensor([[[1.0, 2, 5, 7]]] * 2)
    labels = torch.tensor([[4]] * 2, dtype=torch.int32)
    b1, l1 = transform_boxes(boxes, labels, p, (8, 12))
    b2, l2 = transform_boxes(b1, l1, p, (8, 12))
    np.testing.assert_allclose(b2.numpy(), boxes.numpy(), atol=1e-5)
    assert torch.equal(l2, labels)
    np.testing.assert_allclose(b1[0, 0].numpy(), [12 - 5, 2, 12 - 1, 7], atol=1e-5)


def test_augment_crop_box_geometry():
    """A box through a known window maps by x' = (x − x0)/s."""
    from automoe_tpu_torch.ops.augment import transform_boxes

    s = 0.5  # window: y0 = 0.25·32·0.5 = 4, x0 = 0.5·32·0.5 = 8
    out, lab = transform_boxes(torch.tensor([[[10.0, 6.0, 20.0, 14.0]]]),
                               torch.tensor([[2]]), _port_params(1, s, 0.25, 0.5), (32, 32))
    want = [(10 - 8) / s, (6 - 4) / s, (20 - 8) / s, (14 - 4) / s]
    np.testing.assert_allclose(out[0, 0].numpy(), want, atol=1e-4)
    assert int(lab[0, 0]) == 2


def test_augment_box_leaving_the_crop_is_ignored():
    from automoe_tpu_torch.ops.augment import transform_boxes

    out, lab = transform_boxes(torch.tensor([[[20.0, 20.0, 28.0, 28.0], [4.0, 4.0, 10.0, 10.0]]]),
                               torch.tensor([[5, 7]]), _port_params(1, 0.5), (32, 32))
    assert lab.tolist() == [[-1, 7]]
    assert bool((out >= 0).all() and (out <= 32).all())


def test_augment_mask_rides_the_same_window_nearest():
    from automoe_tpu_torch.ops.augment import augment_masks

    H = W = 16
    mask = torch.arange(H * W, dtype=torch.int32).reshape(1, H, W)
    out = augment_masks(mask, _port_params(1, 0.5, 1.0, 0.0)).numpy()  # y0 = 8, x0 = 0
    ys = 8 + (np.arange(H) + 0.5) * 0.5 - 0.5
    xs = (np.arange(W) + 0.5) * 0.5 - 0.5
    yi = np.clip(np.round(ys).astype(int), 0, H - 1)
    xi = np.clip(np.round(xs).astype(int), 0, W - 1)
    np.testing.assert_array_equal(out[0], mask.numpy()[0][yi][:, xi])


def test_augment_color_jitter_changes_the_image_only():
    from automoe_tpu_torch.ops.augment import AugmentConfig, augment_detection, sample_params

    rng = np.random.default_rng(2)
    batch = _t({"image": rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32),
                "bboxes": np.array([[[1, 1, 6, 6]]] * 2, np.float32),
                "labels": np.array([[0]] * 2, np.int32)})
    cfg = AugmentConfig(hflip_prob=0.0, scale_range=(1.0, 1.0), brightness=0.5,
                        contrast=0.5, saturation=0.5)
    out = augment_detection(batch, sample_params(torch.Generator().manual_seed(1), 2, cfg), cfg)
    assert not np.allclose(out["image"].numpy(), batch["image"].numpy())
    np.testing.assert_allclose(out["bboxes"].numpy(), batch["bboxes"].numpy(), atol=1e-5)


def test_augment_sample_params_follow_the_generator():
    from automoe_tpu_torch.ops.augment import AugmentConfig, sample_params

    cfg = AugmentConfig()
    a = sample_params(torch.Generator().manual_seed(9), 64, cfg)
    b = sample_params(torch.Generator().manual_seed(9), 64, cfg)
    c = sample_params(torch.Generator().manual_seed(10), 64, cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["scale"], c["scale"])
    assert float(a["scale"].min()) >= 0.8 and float(a["scale"].max()) <= 1.0
    for k in ("brightness", "contrast", "saturation"):
        assert float(a[k].min()) >= 0.8 and float(a[k].max()) <= 1.2
    assert 0 < int(a["flip"].sum()) < 64


@pytest.mark.parametrize("what", ["images", "masks", "boxes"])
def test_augment_matches_jax_on_shared_params(what):
    """The same numpy parameters through both packages: images within
    1e-5, masks and labels equal, boxes within 1e-4."""
    from automoe_tpu.ops import augment as J

    from automoe_tpu_torch.ops import augment as P

    rng = np.random.default_rng(3)
    B, H, W = 4, 24, 32
    params = _random_params(rng, B)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}
    if what == "images":
        img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
        np.testing.assert_allclose(P.augment_images(torch.from_numpy(img), tp).numpy(),
                                   np.asarray(jax.jit(J.augment_images)(img, jp)),
                                   rtol=1e-5, atol=1e-5)
    elif what == "masks":
        mask = rng.integers(0, 19, (B, H, W)).astype(np.int32)
        np.testing.assert_array_equal(P.augment_masks(torch.from_numpy(mask), tp).numpy(),
                                      np.asarray(J.augment_masks(jnp.asarray(mask), jp)))
    else:
        xy1 = rng.uniform(0, 0.6, (B, 6, 2)) * [W, H]
        boxes = np.concatenate([xy1, xy1 + rng.uniform(1, 12, (B, 6, 2))], -1).astype(np.float32)
        labels = rng.integers(-1, 10, (B, 6)).astype(np.int32)
        tb, tl = P.transform_boxes(torch.from_numpy(boxes), torch.from_numpy(labels), tp, (H, W))
        jb, jl = J.transform_boxes(jnp.asarray(boxes), jnp.asarray(labels), jp, (H, W))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert (tl.numpy() == -1).sum() > (labels == -1).sum()  # some boxes left the crop


@pytest.mark.parametrize("task", ["detection", "segmentation"])
def test_augment_in_train_only(task):
    """augment=True changes the train loss, is fixed by the key, and
    leaves validation (train=False) bit for bit as without it."""
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    batch = _t(_detection_batch(4) if task == "detection" else
               {**_drivable_batch(4, hw=32),
                "mask": np.random.default_rng(4).integers(0, 19, (2, 32, 32)).astype(np.int32)})
    wa = bdd_expert_workload(task, augment=True, matcher="auction")
    wp = bdd_expert_workload(task, matcher="auction")
    model = wa.init_model(0, "cpu").eval()  # eval: BatchNorm leaves its statistics
    with torch.no_grad():
        la1 = float(wa.loss_fn(model, batch, True, (1, 0))[0])
        la2 = float(wa.loss_fn(model, batch, True, (1, 0))[0])
        la3 = float(wa.loss_fn(model, batch, True, (1, 1))[0])
        lp = float(wp.loss_fn(model, batch, True, (1, 0))[0])
        va, vp = float(wa.loss_fn(model, batch, False)[0]), float(wp.loss_fn(model, batch, False)[0])
    assert la1 == la2 and la1 != la3 and la1 != lp
    assert va == vp


# ---------------------------------------------------------------------------
# fake-quant and QAT
# ---------------------------------------------------------------------------

def test_fake_quant_ste_values_and_grads():
    from automoe_tpu_torch.ops.fake_quant import fake_quant_act, fake_quant_weight

    w = torch.tensor([[1.0, 0.5], [-2.0, 127.0]], requires_grad=True)  # axis 0 = out
    out = fake_quant_weight(w)
    np.testing.assert_allclose(out[1].detach().numpy(), [-2.0, 127.0])
    np.testing.assert_allclose(out[0].detach().numpy(),
                               np.round(np.array([1.0, 0.5]) * 127) / 127, rtol=1e-6)
    (out * 3.0).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), 3.0)
    x = torch.linspace(-1, 1, 64, requires_grad=True)
    xq = fake_quant_act(x)
    s = 1.0 / 127.0
    np.testing.assert_allclose(xq.detach().numpy(), np.round(x.detach().numpy() / s) * s,
                               atol=1e-7)
    xq.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 1.0)


def test_fake_quant_matches_jax():
    """OIHW against the JAX package's HWIO (the output channel moves from
    the last axis to axis 0): values equal, and the activation's too."""
    from automoe_tpu.ops.fake_quant import fake_quant_act as jact
    from automoe_tpu.ops.fake_quant import fake_quant_weight as jweight

    from automoe_tpu_torch.ops.fake_quant import fake_quant_act, fake_quant_weight

    rng = np.random.default_rng(5)
    hwio = (rng.normal(size=(3, 3, 8, 16)) * rng.uniform(0.01, 1, 16)).astype(np.float32)
    want = np.asarray(jweight(jnp.asarray(hwio))).transpose(3, 2, 0, 1)
    got = fake_quant_weight(torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(got.numpy(), want)
    x = rng.normal(size=(2, 8, 5, 5)).astype(np.float32)
    np.testing.assert_array_equal(fake_quant_act(torch.from_numpy(x)).numpy(),
                                  np.asarray(jact(jnp.asarray(x))))


def test_fake_quant_weight_grid_is_the_ptq_grid():
    """fake_quant_weight lands exactly on serving/quant.py's
    quantize_folded grid (same scale, round and clip)."""
    from automoe_tpu_torch.ops.fake_quant import fake_quant_weight
    from automoe_tpu_torch.serving.quant import quantize_folded

    w = (np.random.default_rng(6).normal(size=(16, 8, 3, 3)) * 0.1).astype(np.float32)
    q = quantize_folded({"c": {"w": w, "b": np.zeros(16, np.float32)}}, frozenset())["c"]
    deq = q["wq"].astype(np.float32) * q["sw"][:, None, None, None]
    np.testing.assert_allclose(fake_quant_weight(torch.from_numpy(w)).numpy(), deq,
                               rtol=0, atol=1e-7)


def test_fake_quant_commutes_with_bn_folding():
    """fq(c ⊙ W) == c ⊙ fq(W) per output channel, any sign of c."""
    from automoe_tpu_torch.ops.fake_quant import fake_quant_weight

    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(8, 4, 3, 3)).astype(np.float32))
    c = rng.normal(size=8).astype(np.float32) * 2.0
    c[np.abs(c) < 0.1] = 0.5
    c = torch.from_numpy(c)[:, None, None, None]
    np.testing.assert_allclose(fake_quant_weight(w * c).numpy(),
                               (fake_quant_weight(w) * c).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("option", ["qat", "remat"])
def test_options_keep_the_state_dict(option):
    from automoe_tpu_torch.models.experts import BDDDrivableExpert, NuScenesExpert

    for cls in (BDDDrivableExpert, NuScenesExpert):
        a, b = cls().state_dict(), cls(**{option: True}).state_dict()
        assert [(k, v.shape) for k, v in a.items()] == [(k, v.shape) for k, v in b.items()]


@pytest.fixture(scope="module")
def jax_drivable():
    """The JAX drivable workload at 64 px and numpy variables with
    normalisation away from identity, and the port's model on them."""
    from automoe_tpu.train.workloads import bdd_expert_workload

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax

    wl = bdd_expert_workload("drivable", image_size=HW)
    v = jax.device_get(wl.init_variables(jax.random.key(0)))
    rng = np.random.default_rng(11)
    variables = {"params": _perturb_norms(v["params"], rng),
                 "batch_stats": _perturb_norms(v["batch_stats"], rng)}
    return {"wl": wl, "variables": variables,
            "state_dict": expert_state_dict_from_jax(variables, "drivable")}


def _port_drivable(state_dict, **kw):
    from automoe_tpu_torch.models.experts import BDDDrivableExpert

    m = BDDDrivableExpert(**kw)
    m.load_state_dict(state_dict, strict=True)
    return m


def test_qat_forward_matches_jax(jax_drivable):
    """Each QAT BasicBlock of the trunk in eval mode, on the same weights
    and the same input (the port's stage output fed to both): mean
    relative error under 1e-4. A 1e-6 difference in a conv output can
    move one activation across a rounding boundary (one grid step); fed
    forward through eight blocks such steps compound to percents, so the
    blocks are held one at a time: layer1_0, layer2_0 (with its
    downsample conv) and layer4_1."""
    from automoe_tpu.models.resnet import BasicBlock as JaxBlock

    from automoe_tpu_torch.models.resnet import STAGES

    params = jax_drivable["variables"]["params"]["backbone"]
    stats = jax_drivable["variables"]["batch_stats"]["backbone"]
    backbone = _port_drivable(jax_drivable["state_dict"], qat=True).eval().backbone
    with torch.no_grad():
        h = nchw(_drivable_batch(12, b=2)["image"])
        for m in list(backbone)[:4]:
            h = m(h)
        for s, (filters, stride) in enumerate(STAGES, start=1):
            for b in (0, 1):
                name = f"layer{s}_{b}"
                held = name in ("layer1_0", "layer2_0", "layer4_1")
                block = JaxBlock(filters, stride if b == 0 else 1, qat=True)
                want = np.asarray(jax.jit(lambda v, t: block.apply(v, t, False))(
                    {"params": params[name], "batch_stats": stats[name]},
                    h.permute(0, 2, 3, 1).numpy())) if held else None
                h = backbone[3 + s][b](h)
                if held:
                    got = h.permute(0, 2, 3, 1).numpy()
                    err = float(np.abs(got - want).mean() / np.abs(want).mean())
                    assert err < 1e-4, (name, err)


def test_qat_forward_predicts_the_int8_forward(jax_drivable):
    """Block by block through the trunk, each block fed the float
    forward's activation (the tensors the int8 path was calibrated on,
    quantized at the calibrated scale for the q8 block, through the q8
    trunk's own block code): the QAT block's output is closer to the q8
    block's than the float block's is, at every block, and its MSE is
    under 0.6 of the float block's on average. QAT (as in the JAX
    package) does not model the q8 trunk's int8 identity residual, and
    its activation scales are the batch's, not the calibrated ones; so
    over the whole trunk, where the int8 path's inputs drift from the
    calibration tensors, it is no closer than the float forward
    (ROADMAP §3). The stem runs through K3's plain version elsewhere
    (test_torch_port_quant.py)."""
    from automoe_tpu_torch.models.resnet import STAGES
    from automoe_tpu_torch.serving.quant import (
        _act_scale,
        fold_resnet,
        pack_trunk,
        q8_block,
        quantize_folded,
        quantize_int8,
        resnet_float_forward,
    )

    x = nchw(_drivable_batch(13, b=4)["image"])
    fp = _port_drivable(jax_drivable["state_dict"]).eval().backbone
    qat = _port_drivable(jax_drivable["state_dict"], qat=True).eval().backbone
    ratios = []
    with torch.no_grad():
        folded = fold_resnet(fp)
        amax = {}
        resnet_float_forward(folded, x, collect=amax)
        scales = {k: float(v) for k, v in amax.items()}
        q = quantize_folded(folded)
        trunk = pack_trunk(q, scales, "cpu")
        h = x
        for m in list(fp)[:4]:
            h = m(h)
        for s, (_, stride) in enumerate(STAGES, start=1):
            for b in (0, 1):
                si = _act_scale(scales[f"layer{s}_{b}/conv1"])
                xq = quantize_int8(h.permute(0, 2, 3, 1), float(np.float32(1.0 / si)))
                y8 = q8_block(trunk, scales, f"layer{s}_{b}", xq, si, stride if b == 0 else 1)
                yq = qat[3 + s][b](h).permute(0, 2, 3, 1)
                h = fp[3 + s][b](h)
                yf = h.permute(0, 2, 3, 1)
                ratios.append(float(((yq - y8) ** 2).mean() / ((yf - y8) ** 2).mean()))
    # measured: 0.004 (blocks with a downsample conv) to 0.89, mean 0.42
    assert max(ratios) < 1.0 and np.mean(ratios) < 0.6, ratios


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_remat_step_equals_the_plain_step(qat):
    """One AdamW step with remat on and off: parameters, BatchNorm running
    statistics and their step counts equal (the recomputation in the
    backward does not move the running statistics again)."""
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    batch = _t(_detection_batch(8))
    states, grads = [], []
    for remat in (False, True):
        wl = bdd_expert_workload("detection", matcher="auction", remat=remat, qat=qat)
        model = wl.init_model(3, "cpu")
        opt = make_optimizer(model.named_parameters(), learning_rate=1e-3, total_steps=4)
        make_train_step(wl.loss_fn)(model, opt, batch, (1, 0))
        states.append(_state(model))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    _assert_states_equal(*states)
    _assert_states_equal(*grads)
    assert int(states[1]["backbone.4.0.bn1.num_batches_tracked"]) == 1


# ---------------------------------------------------------------------------
# gradient accumulation and steps per call
# ---------------------------------------------------------------------------

def _port_setup(wl, seed=3, lr=1e-2, ema=0.0, sgd=True):
    from automoe_tpu_torch.train.state import make_optimizer

    model = wl.init_model(seed, "cpu")
    opt = make_optimizer(model.named_parameters(), learning_rate=lr, weight_decay=0.0,
                         total_steps=8, optimizer="sgd" if sgd else "adamw", ema_decay=ema)
    return model, opt


def _stack(batches):
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}


def test_accum_k1_equals_the_plain_step():
    from automoe_tpu_torch.train.step import make_grad_accum_train_step, make_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    wl = bdd_expert_workload("drivable")
    b = _drivable_batch(20, hw=32)
    m1, o1 = _port_setup(wl)
    m2, o2 = _port_setup(wl)
    a = make_train_step(wl.loss_fn)(m1, o1, _t(b), (1, 0))
    c = make_grad_accum_train_step(wl.loss_fn)(m2, o2, _stack([b]), (1, 0))
    _assert_states_equal(_state(m1), _state(m2))
    assert float(a["loss"]) == float(c["loss"])


def test_accum_equals_a_manual_two_gradient_average():
    """K=2: the step applies the mean of the two microbatch gradients,
    each microbatch normalised by its own statistics, running statistics
    moved twice in order; metrics are the mean."""
    from automoe_tpu_torch.train.step import make_grad_accum_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    wl = bdd_expert_workload("drivable")
    bs = [_drivable_batch(21, hw=32), _drivable_batch(22, hw=32)]
    m1, o1 = _port_setup(wl)
    out = make_grad_accum_train_step(wl.loss_fn)(m1, o1, _stack(bs), (1, 0))
    m2, o2 = _port_setup(wl)
    m2.train()
    grads, losses = [], []
    for b in bs:
        o2.zero_grad()
        loss, _ = wl.loss_fn(m2, _t(b), True)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in o2.params})
        losses.append(float(loss.detach()))
    for n, p in o2.params:
        p.grad = (grads[0][n] + grads[1][n]) / 2
    o2.step()
    _assert_states_equal(_state(m1), _state(m2), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(out["loss"]), np.mean(losses), rtol=1e-6)


def test_accum_step_matches_jax(jax_drivable):
    """One K=2 accumulated SGD step with an EMA (d 0.9) in both packages
    from the same weights: parameters, running statistics and the EMA
    within rtol 1e-4 / atol 1e-6, the averaged loss within 1e-5."""
    from automoe_tpu.train.state import TrainState
    from automoe_tpu.train.state import make_optimizer as jax_make_optimizer
    from automoe_tpu.train.step import make_grad_accum_train_step as jax_accum

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.state import make_optimizer
    from automoe_tpu_torch.train.step import make_grad_accum_train_step
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    v = jax_drivable["variables"]
    bs = [_drivable_batch(30), _drivable_batch(31)]
    tx = jax_make_optimizer(learning_rate=1e-2, weight_decay=0.0, total_steps=4,
                            optimizer="sgd")
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the step donates)
    st = TrainState.create(params=copy(v["params"]), tx=tx,
                           batch_stats=copy(v["batch_stats"]), ema_decay=0.9)
    st, jm = jax_accum(jax_drivable["wl"].loss_fn)(
        st, {k: np.stack([b[k] for b in bs]) for k in bs[0]}, jax.random.key(0))
    want = expert_state_dict_from_jax(
        {"params": jax.device_get(st.params), "batch_stats": jax.device_get(st.batch_stats)},
        "drivable")
    want_ema = expert_state_dict_from_jax(
        {"params": jax.device_get(st.ema_params), "batch_stats": v["batch_stats"]}, "drivable")

    model = _port_drivable(jax_drivable["state_dict"])
    opt = make_optimizer(model.named_parameters(), learning_rate=1e-2, weight_decay=0.0,
                         total_steps=4, optimizer="sgd", ema_decay=0.9)
    pm = make_grad_accum_train_step(bdd_expert_workload("drivable").loss_fn)(
        model, opt, _stack(bs), (1, 0))
    got = {k: v for k, v in _state(model).items() if not k.endswith("num_batches_tracked")}
    _assert_states_equal(got, {k: want[k] for k in got}, rtol=1e-4, atol=1e-6)
    ema = opt.ema.state_dict()
    _assert_states_equal({k: v.clone() for k, v in ema.items()},
                         {k: want_ema[k] for k in ema}, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_steps_per_call_equals_single_steps():
    """K=2 steps in one call (stacked batches) leave the model, the AdamW
    state and the EMA as two single steps do, dropout and augmentation
    drawn from the same keys (the nuScenes-2D head has dropout)."""
    from automoe_tpu_torch.train.step import make_scan_train_step, make_train_step
    from automoe_tpu_torch.train.workloads import carla_nuscenes_2d_workload

    wl = carla_nuscenes_2d_workload(num_queries=8, augment=True, matcher="hungarian")
    bs = [_detection_batch(40 + i) for i in range(2)]
    m1, o1 = _port_setup(wl, sgd=False, ema=0.9, lr=1e-3)
    step = make_train_step(wl.loss_fn)
    losses = [float(step(m1, o1, _t(b), (1, o1.count))["loss"]) for b in bs]
    m2, o2 = _port_setup(wl, sgd=False, ema=0.9, lr=1e-3)
    out = make_scan_train_step(wl.loss_fn)(m2, o2, _stack(bs), (1, 0))
    assert out["loss"].tolist() == losses and o1.count == o2.count == 2
    _assert_states_equal(_state(m1), _state(m2))
    _assert_states_equal(o1.ema.state_dict(), o2.ema.state_dict())
    for n in o1.state:
        assert all(torch.equal(a, b) for a, b in zip(o1.state[n], o2.state[n]))


class _Tiny(torch.nn.Module):
    """A conv, a BatchNorm and dropout: what the loop's bookkeeping needs,
    at a size that trains in milliseconds."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(4)
        self.drop = torch.nn.Dropout(0.3)
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(self.drop(torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))))


def _tiny_loss(model, batch, train, key=None):
    logits = model(batch["image"].permute(0, 3, 1, 2))
    loss = torch.nn.functional.cross_entropy(logits, batch["label"])
    return loss, {"acc": (logits.argmax(-1) == batch["label"]).float().mean()}


def _tiny_batches(seed, n):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
             "label": rng.integers(0, 3, 4)} for _ in range(n)]


class _Batches:
    """A plain iterable of host batches that can stop after `crash_after`."""

    def __init__(self, batches, crash_after=None):
        self.batches, self.crash_after = batches, crash_after

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if self.crash_after is not None and i == self.crash_after:
                raise KeyboardInterrupt("simulated crash")
            yield b


def _trainer(tmp, run, batches, val=None, **kw):
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import Workload

    cfg = dict(epochs=1, learning_rate=1e-2, seed=5, run_name=run, ckpt_root=str(tmp / "ck"),
               runs_root=str(tmp / "runs"), device="cpu")
    return Trainer(Workload("tiny", _Tiny, _tiny_loss), batches,
                   _Batches((val or batches)[:2]), TrainConfig(**{**cfg, **kw}))


def _epoch_losses(tmp, run):
    recs = [json.loads(line) for line in
            (tmp / "runs" / f"tiny_{run}" / "metrics.jsonl").read_text().splitlines()]
    return [r["train/loss_epoch"] for r in recs if "train/loss_epoch" in r]


def test_max_inflight_changes_neither_losses_nor_checkpoints(tmp_path):
    from automoe_tpu_torch.ckpt import load_checkpoint

    batches = _tiny_batches(50, 5)
    for run, inflight in (("sync", 0), ("inflight2", 2)):
        _trainer(tmp_path, run, batches, max_inflight=inflight, ema_decay=0.5).fit()
    assert _epoch_losses(tmp_path, "sync") == _epoch_losses(tmp_path, "inflight2")
    a = load_checkpoint(tmp_path / "ck" / "tiny" / "sync" / "last.pt")
    b = load_checkpoint(tmp_path / "ck" / "tiny" / "inflight2" / "last.pt")
    for part in ("model_state_dict", "ema_state_dict"):
        _assert_states_equal(a[part], b[part])
    assert a["step"] == b["step"] == 5
    shutil.rmtree(tmp_path / "ck")


@pytest.mark.parametrize("k,steps", [(1, 5), (2, 3), (3, 3), (4, 2)])
def test_accum_schedule_counts_optimizer_steps(tmp_path, k, steps):
    """5 batches with --grad-accum K: 5 // K + 5 % K optimizer steps an
    epoch (the tail runs as single steps), and the schedule is that long,
    as the JAX Trainer's."""
    batches = _tiny_batches(60, 5)
    tr = _trainer(tmp_path, f"k{k}", batches, grad_accum=k, epochs=2)
    assert tr.optimizer.steps_per_epoch == steps and tr.optimizer.total_steps == 2 * steps
    tr.train_epoch(0)
    assert tr.optimizer.count == steps
    tr.logger.close()


def test_accum_with_steps_per_call_raises(tmp_path):
    with pytest.raises(ValueError, match="exclusive"):
        _trainer(tmp_path, "x", _tiny_batches(0, 1), grad_accum=2, steps_per_call=2)


def test_steps_per_call_runs_the_tail_as_single_steps(tmp_path):
    """5 batches, K=2: two calls of two steps and one single step, the
    same parameters as five single steps (dropout included)."""
    batches = _tiny_batches(70, 5)
    a = _trainer(tmp_path, "single", batches)
    b = _trainer(tmp_path, "spc", batches, steps_per_call=2)
    for tr in (a, b):
        tr.train_epoch(0)
        tr.logger.close()
    assert a.optimizer.count == b.optimizer.count == 5
    _assert_states_equal(_state(a.model), _state(b.model))


def test_accum_resume_from_a_step_checkpoint_equals_an_unbroken_run(tmp_path):
    """--grad-accum 2 --save-every-steps 2: a run that stops in its third
    group and resumes from the `step` checkpoint ends where an unbroken
    run does (dropout and the EMA included)."""
    batches = _tiny_batches(80, 6)
    kw = dict(grad_accum=2, save_every_steps=2, ema_decay=0.9)
    whole = _trainer(tmp_path, "whole", batches, **kw)
    whole.fit()
    crashed = _trainer(tmp_path, "part", _Batches(batches, crash_after=5), val=batches, **kw)
    with pytest.raises(KeyboardInterrupt):
        crashed.fit()
    resumed = _trainer(tmp_path, "part", batches, resume="full", resume_from="step", **kw)
    assert (resumed.start_epoch, resumed.start_batch, resumed.optimizer.count) == (0, 4, 2)
    resumed.fit()
    _assert_states_equal(_state(whole.model), _state(resumed.model))
    _assert_states_equal(whole.optimizer.ema.state_dict(), resumed.optimizer.ema.state_dict())
    shutil.rmtree(tmp_path / "ck")


def test_debug_nans_raises_at_the_first_non_finite_loss(tmp_path):
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import Workload

    def loss_fn(model, batch, train, key=None):
        y = model(batch["x"])
        return (y * batch["scale"]).mean(), {}

    wl = Workload("nan", lambda: torch.nn.Linear(3, 1), loss_fn)
    batches = [{"x": np.ones((2, 3), np.float32), "scale": np.float32(s)}
               for s in (1.0, np.nan, 1.0)]
    cfg = TrainConfig(runs_root=str(tmp_path), ckpt_root=str(tmp_path), device="cpu",
                      debug_nans=True)
    tr = Trainer(wl, batches, batches, cfg)
    with pytest.raises((FloatingPointError, RuntimeError)):
        tr.train_epoch(0)
    assert tr.optimizer.count <= 2
    tr.logger.close()


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------

def test_ema_update_matches_jax():
    """Three SGD steps with d=0.5 against TrainState.apply_gradients:
    parameters and EMA within rtol 1e-6."""
    import optax

    from automoe_tpu.train.state import TrainState

    from automoe_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(3, 4)).astype(np.float32)
    st = TrainState.create(params={"w": jnp.asarray(p0)}, tx=optax.sgd(0.1), ema_decay=0.5)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([("w", w)], learning_rate=0.1, weight_decay=0.0, total_steps=3,
                         optimizer="sgd", schedule="constant", grad_clip=1e9, ema_decay=0.5)
    for _ in range(3):
        g = rng.normal(size=(3, 4)).astype(np.float32)
        st = st.apply_gradients({"w": jnp.asarray(g)})
        w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(st.params["w"]), rtol=1e-6)
        np.testing.assert_allclose(opt.ema.state_dict()["w"].numpy(),
                                   np.asarray(st.ema_params["w"]), rtol=1e-6)


def test_ema_is_off_by_default_and_does_not_alias():
    from automoe_tpu_torch.train.state import make_optimizer

    w = torch.nn.Parameter(torch.ones(3))
    assert make_optimizer([("w", w)], learning_rate=0.1, total_steps=1).ema is None
    opt = make_optimizer([("w", w)], learning_rate=0.1, total_steps=1, ema_decay=0.9)
    e = opt.ema.state_dict()["w"]
    assert e.data_ptr() != w.data_ptr() and torch.equal(e, w.detach())
    with torch.no_grad():
        w.add_(1.0)
    assert torch.equal(e, torch.ones(3))


def test_ema_covers_frozen_parameters():
    """With a trainable mask the frozen parameters keep an EMA too, and
    it stays at them (up to rounding), as in the JAX TrainState."""
    from automoe_tpu_torch.train.state import make_optimizer

    a, b = torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.full((4,), 0.3))
    opt = make_optimizer([("a", a), ("b", b)], learning_rate=0.1, total_steps=4,
                         trainable_mask={"a": True, "b": False}, ema_decay=0.9)
    for _ in range(4):
        a.grad = torch.ones(4)
        opt.step()
    ema = opt.ema.state_dict()
    np.testing.assert_allclose(ema["b"].numpy(), 0.3, rtol=1e-6)
    assert not torch.allclose(ema["a"], a.detach())


def test_ema_checkpoint_round_trip_and_asymmetries(tmp_path):
    """The EMA lands in every checkpoint; restoring it into a run with an
    EMA reproduces it; a run without one ignores it; a run with one from
    a checkpoint without it starts it at the restored parameters."""
    batches = _tiny_batches(90, 3)
    tr = _trainer(tmp_path, "ema", batches, ema_decay=0.9)
    tr.fit()
    saved = {k: v.clone() for k, v in tr.optimizer.ema.state_dict().items()}
    plain = _trainer(tmp_path, "plain", batches)
    plain.fit()
    back = _trainer(tmp_path, "ema", batches, ema_decay=0.9, resume="full")
    _assert_states_equal(back.optimizer.ema.state_dict(), saved)
    no_ema = _trainer(tmp_path, "ema", batches, resume="model")
    assert no_ema.resumed and no_ema.optimizer.ema is None
    seeded = _trainer(tmp_path, "plain", batches, ema_decay=0.9, resume="model")
    params = dict(seeded.model.named_parameters())
    _assert_states_equal(seeded.optimizer.ema.state_dict(),
                         {k: params[k].detach() for k in params})
    shutil.rmtree(tmp_path / "ck")


def test_prefer_ema_loads_the_ema_and_raises_without_one(tmp_path):
    from automoe_tpu_torch.ckpt import load_variables

    batches = _tiny_batches(95, 3)
    _trainer(tmp_path, "ema", batches, ema_decay=0.5).fit()
    _trainer(tmp_path, "plain", batches).fit()
    ck = tmp_path / "ck" / "tiny"
    m = _Tiny()
    load_variables(ck / "ema" / "last.pt", m, prefer_ema=True)
    payload = torch.load(ck / "ema" / "last.pt", weights_only=True)
    for k, v in m.state_dict().items():
        want = payload["ema_state_dict"].get(k, payload["model_state_dict"][k])
        assert torch.equal(v, want), k
    with pytest.raises(KeyError, match="EMA"):
        load_variables(ck / "plain" / "last.pt", m, prefer_ema=True)
    shutil.rmtree(tmp_path / "ck")


@pytest.mark.parametrize("argv,msg", [
    (["--ema"], "needs --checkpoint"),
    (["--ema", "--checkpoint", "{ckpt}.pth"], "not a .pth"),
])
def test_serve_cli_ema_guards(tmp_path, argv, msg):
    from automoe_tpu_torch.serving.cli import main

    (tmp_path / "ckpt.pth").write_bytes(b"")
    argv = [a.replace("{ckpt}", str(tmp_path / "ckpt")) for a in argv]
    with pytest.raises(SystemExit, match=msg):
        main(argv + ["--device", "cpu"], block=False)


def test_engine_serves_the_ema_weights(tmp_path):
    """InferenceEngine.from_torch_checkpoint(prefer_ema=True) takes the
    EMA of every parameter and the checkpoint's BatchNorm statistics."""
    from automoe_tpu_torch.configs import default_model_config
    from automoe_tpu_torch.infer import InferenceEngine
    from automoe_tpu_torch.models import create_automoe_model

    cfg = default_model_config()
    sd = create_automoe_model(cfg, device="cpu", seed=1).state_dict()
    ema = {k: v + 0.25 for k, v in sd.items() if v.is_floating_point()
           and not k.endswith(("running_mean", "running_var"))}
    path = tmp_path / "best.pt"
    torch.save({"model_state_dict": sd, "ema_state_dict": ema}, path)
    eng = InferenceEngine.from_torch_checkpoint(cfg, str(path), prefer_ema=True,
                                                camera_hw=(32, 32), model_hw=(32, 32),
                                                dtype=torch.float32, device="cpu")
    got = eng.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], ema.get(k, v)), k


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def _flat(tree, keys):
    return np.concatenate([np.asarray(tree[k], np.float64).ravel() for k in keys])


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_bf16_loss_and_grads_at_tests_bf16_bars(jax_drivable):
    """tests/test_bf16.py's bars, held by the port's bf16 (autocast)
    against its own f32 and against the JAX package's bf16 workload on the
    same weights and batch: loss within 2%, head-gradient cosine above
    0.95, backbone cosines above 0.7, gradient-norm ratio within 10%; the
    gradients reach the f32 parameters in f32."""
    from automoe_tpu.train.workloads import bdd_expert_workload as jax_workload

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.workloads import bdd_expert_workload

    v = jax_drivable["variables"]
    batch = _drivable_batch(100, b=4)
    wl16 = jax_workload("drivable", image_size=HW, dtype=jnp.bfloat16)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: wl16.loss_fn(
        p, v["batch_stats"], batch, jax.random.key(1), True)[0]))(v["params"])
    jg = expert_state_dict_from_jax({"params": jax.device_get(jg),
                                     "batch_stats": v["batch_stats"]}, "drivable")
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = _port_drivable(jax_drivable["state_dict"]).train()
        loss, _ = bdd_expert_workload("drivable", dtype=dtype).loss_fn(model, _t(batch), True)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        assert all(g.dtype == torch.float32 for g in grads.values())
        assert all(p.dtype == torch.float32 for p in model.parameters())
        runs[dtype] = (float(loss.detach()), {n: g.numpy() for n, g in grads.items()})
    l16, g16 = runs[torch.bfloat16]
    keys = list(g16)
    for name, (l_ref, g_ref) in (("port f32", runs[torch.float32]),
                                 ("jax bf16", (float(jl), jg))):
        assert abs(l16 - l_ref) / l_ref < 0.02, (name, l16, l_ref)
        assert _cos(_flat(g16, ["decoder.0.weight"]), _flat(g_ref, ["decoder.0.weight"])) > 0.95
        for prefix in ("backbone.0.", "backbone.4.0.", "backbone.7.1."):
            sub = [k for k in keys if k.startswith(prefix)]
            c = _cos(_flat(g16, sub), _flat(g_ref, sub))
            assert c > 0.7, (name, prefix, c)
        ratio = np.linalg.norm(_flat(g16, keys)) / np.linalg.norm(_flat(g_ref, keys))
        assert abs(ratio - 1.0) < 0.1, (name, ratio)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_runs_detection_with_the_step_options(tmp_path):
    """`bdd --task detection --augment --qat --ema-decay 0.99 --grad-accum 2
    --max-inflight 2 --profile-dir` for an epoch on a synthetic BDD cache:
    the checkpoint carries the EMA, the metrics log val_ema, the trace is
    written."""
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.tools.synth import synth_bdd_detection
    from automoe_tpu_torch.train.cli import main

    root = synth_bdd_detection(tmp_path / "bdd", n_per_split={"train": 8, "val": 4}, size=64,
                               max_boxes=3)
    res = main(["bdd", "--task", "detection", "--data-root", str(root), "--image-size", "64",
                "--box-cap", "4", "--batch-size", "2", "--epochs", "1", "--num-workers", "1",
                "--augment", "--qat", "--ema-decay", "0.99", "--grad-accum", "2",
                "--max-inflight", "2", "--profile-dir", str(tmp_path / "prof"),
                "--device", "cpu", "--ckpt-root", str(tmp_path / "ck"),
                "--runs-root", str(tmp_path / "runs")])
    assert np.isfinite(res["best_val_loss"])
    last = load_checkpoint(tmp_path / "ck" / "bdd_detection" / "run" / "last.pt")
    assert last["step"] == 2  # 4 batches, 2 a step
    assert set(last["ema_state_dict"]) == {k for k, v in last["model_state_dict"].items()
                                           if "running" not in k and "num_batches" not in k}
    recs = [json.loads(line) for line in
            (tmp_path / "runs" / "bdd_detection_run" / "metrics.jsonl").read_text().splitlines()]
    ema = [r for r in recs if "val_ema/loss" in r]
    assert len(ema) == 1 and res["best_val_loss"] == pytest.approx(ema[0]["val_ema/loss"])
    assert list((tmp_path / "prof").glob("trace_*.json"))
    shutil.rmtree(tmp_path / "ck")


@pytest.mark.parametrize("cmd,factory", [
    (["bdd", "--task", "segmentation"], "bdd_expert_workload"),
    (["finetune-carla", "--task", "detection"], "bdd_expert_workload"),
    (["nuscenes-2d"], "carla_nuscenes_2d_workload"),
    (["nuscenes"], "nuscenes_workload"),
])
def test_cli_threads_the_options_to_the_workload(monkeypatch, tmp_path, cmd, factory):
    from automoe_tpu_torch.train import cli

    seen = {}

    def fake(*a, **kw):
        seen.update(kw)
        raise SystemExit(0)

    monkeypatch.setattr(cli.W, factory, fake)
    with pytest.raises(SystemExit):
        cli.main(cmd + ["--data-root", str(tmp_path), "--bf16", "--remat", "--qat",
                        "--augment"])
    assert seen["dtype"] == torch.bfloat16 and seen["remat"] and seen["qat"]
    assert seen.get("augment", True)  # nuscenes takes none, as in JAX


@pytest.mark.parametrize("cmd,notes", [
    (["policy", "--epochs", "1"], ("--remat", "--qat", "--augment")),
    (["gating"], ("--remat", "--qat", "--augment")),
    (["nuscenes"], ("--augment",)),
])
def test_cli_notes_options_without_effect(monkeypatch, capsys, tmp_path, cmd, notes):
    from automoe_tpu_torch.train import cli

    def stop(*a, **kw):
        raise SystemExit(0)

    for f in ("policy_workload", "gating_workload", "nuscenes_workload"):
        monkeypatch.setattr(cli.W, f, stop)
    with pytest.raises(SystemExit):
        cli.main(cmd + ["--data-root", str(tmp_path), "--remat", "--qat", "--augment"])
    out = capsys.readouterr().out
    for flag in notes:
        assert f"{flag}: no effect" in out, (flag, out)


def test_cli_step_options_reach_the_train_config(monkeypatch, tmp_path):
    from automoe_tpu_torch.train import cli

    seen = {}

    class FakeTrainer:
        def __init__(self, wl, train, val, cfg):
            seen["cfg"] = cfg
            raise SystemExit(0)

    monkeypatch.setattr(cli, "Trainer", FakeTrainer)
    monkeypatch.setattr(cli, "_sized_loaders", lambda *a, **kw: ([], []))
    with pytest.raises(SystemExit):
        cli.main(["finetune-carla", "--task", "drivable", "--ema-decay", "0.999",
                  "--steps-per-call", "4", "--max-inflight", "0", "--debug-nans",
                  "--profile-dir", "p"])
    c = seen["cfg"]
    assert (c.ema_decay, c.steps_per_call, c.max_inflight, c.debug_nans, c.profile_dir,
            c.grad_accum) == (0.999, 4, 0, True, "p", 1)
    with pytest.raises(SystemExit):
        cli.main(["finetune-carla", "--task", "drivable"])
    c = seen["cfg"]  # the JAX defaults
    assert (c.ema_decay, c.steps_per_call, c.max_inflight, c.grad_accum, c.log_every,
            c.grad_clip) == (0.0, 1, 2, 1, 50, 1.0)
