"""The port's nuScenes paths against the JAX package on the CPU, on the
same numpy inputs and weights:

* `pad_points`, `boxes_to_arrays` (devkit Box-like stubs) and
  `NuScenesDataset` / its loader: exact, the string token included;
* TNet, PointNet and the LiDAR `NuScenesExpert` (use_tnet + concat, and
  sum without TNets) in eval mode and with train-mode BatchNorm, B=8, 64
  points, weights carried by `from_jax`: outputs rtol 1e-4 with atol 5e-5
  of their largest magnitude (`_close` says why), running statistics rtol
  1e-4 / atol 1e-5; `NuScenesImage2DHead` in eval mode: rtol 1e-4 / atol
  1e-5;
* naming: the port's state dicts, fed through the JAX package's
  `import_nuscenes_expert` / `import_nuscenes_2d_head`, give back the
  very variables they were loaded from;
* `nuscenes_set_loss` with the auction matcher on both sides, and with
  K1's plain version (`auction_kernel`) against `auction_pallas` in
  interpret mode, Q=16, N=4, D=7: identical matches, losses rtol 1e-5;
* the 2D fine-tune's exact match: scipy's `hungarian_match` and K2's
  plain version alone (`auction_kernel:0`) give JAX's `hungarian_match`
  indices on tie-free costs; its loss on the same weights: rtol 1e-4;
* a 3-step SGD trajectory of the LiDAR workload (dropout off on both
  sides, train-mode BatchNorm): losses rtol 1e-4, parameters rtol 1e-3 /
  atol 1e-5;
* `nuscenes` and `nuscenes-2d` through the CLI on the CPU.
The JAX value-and-grad is compiled once, by the trajectory."""
from __future__ import annotations

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_common import _perturb_norms, nchw

from tests.torch_port_common import tmp_path, module_tmp  # noqa: F401  (removes what tests write)
# B=8: the PointNet's fc BatchNorms normalise over the batch alone; at
# B=4 some channel's batch mean is ~40 batch standard deviations, where
# float32 (and more so JAX's E[x²]−E[x]² variance) loses ~1e-4 relative
S, B, P, Q, N, N_STEPS, LR = 64, 8, 64, 16, 4, 3, 1e-3


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

class _Quat:
    def __init__(self, ypr=None, R=None):
        if ypr is not None:
            self.yaw_pitch_roll = ypr
        if R is not None:
            self.rotation_matrix = R


class _Box:
    """A devkit Box-like: center, wlh, orientation, name."""

    def __init__(self, name, center, wlh, orientation):
        self.name, self.center, self.wlh, self.orientation = name, center, wlh, orientation


def _boxes():
    t = 0.7
    rot = [[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]]
    return [
        _Box("vehicle.car", [1.0, 2.0, 0.5], [1.8, 4.2, 1.5], _Quat(ypr=(0.3, 0.0, 0.0))),
        _Box("Human.Pedestrian.Adult", np.array([3.0, -1.0, 0.2]), [0.6, 0.7, 1.8],
             _Quat(R=rot)),
        _Box("animal", [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], None),  # not a class: dropped
        _Box("movable_object.trafficcone", [5.0, 5.0, 0.0], [0.3, 0.3, 0.8], None),
        _Box("barrier", [6.0, 1.0, 0.0], [2.0, 0.4, 1.0], _Quat(ypr="bad")),
    ]


@pytest.mark.parametrize("n", [0, 10, 80])
def test_pad_points_matches_jax(n):
    from automoe_tpu.data.collate import pad_points as jax_pad

    from automoe_tpu_torch.data.collate import pad_points

    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    np.testing.assert_array_equal(pad_points(pts, 32), jax_pad(pts, 32))


@pytest.mark.parametrize("boxes", ["stubs", "empty"])
def test_boxes_to_arrays_matches_jax(boxes):
    from automoe_tpu.data.datasets import boxes_to_arrays as jax_b2a

    from automoe_tpu_torch.data.datasets import boxes_to_arrays

    lst = _boxes() if boxes == "stubs" else []
    (b, lab), (jb, jl) = boxes_to_arrays(lst), jax_b2a(lst)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(lab, jl)
    if boxes == "stubs":
        assert lab.tolist() == [0, 5, 8, 9]
        np.testing.assert_allclose(b[:, 6], [0.3, 0.7, 0.0, 0.0], rtol=1e-6)


@pytest.fixture(scope="module")
def nus_root(module_tmp):
    from automoe_tpu_torch.tools.synth import synth_nuscenes

    root = synth_nuscenes(module_tmp("nus"), n_per_split={"train": 5, "val": 3},
                          size=S, points=48, max_boxes=6, seed=2)
    sample = torch.load(root / "train" / "00000.pt", weights_only=False)
    sample["boxes"], sample["token"] = _boxes(), "stubbed"  # devkit Box-likes
    torch.save(sample, root / "train" / "00000.pt")
    return root


def test_nuscenes_dataset_matches_jax(nus_root):
    from automoe_tpu.data.datasets import NuScenesDataset as JaxDataset

    from automoe_tpu_torch.data.datasets import NuScenesDataset

    kw = dict(lidar_cap=P, box_cap=N + 1)  # P=64 truncates some clouds and pads others
    mine, ref = NuScenesDataset(nus_root / "train", **kw), JaxDataset(nus_root / "train", **kw)
    assert len(mine) == len(ref) == 5
    for i in range(len(ref)):
        a, b = mine[i], ref[i]
        assert sorted(a) == sorted(b)
        assert a["token"] == b["token"]
        for k in b:
            if k != "token":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert mine[0]["labels"].tolist() == [0, 5, 8, 9, -1] and mine[0]["token"] == "stubbed"


def test_nuscenes_loader_matches_jax(nus_root):
    from automoe_tpu.data.factories import get_nuscenes_loader as jax_loader

    from automoe_tpu_torch.data import get_nuscenes_loader

    for split in ("train", "val"):
        kw = dict(split=split, batch_size=2, num_workers=2, root_dir=str(nus_root),
                  lidar_cap=P, box_cap=N)
        mine, ref = get_nuscenes_loader(**kw), jax_loader(**kw)
        mine.set_epoch(1)
        ref.set_epoch(1)
        got, want = list(mine), list(ref)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            assert isinstance(a["token"], list) and a["token"] == list(b["token"])
            for k in b:
                if k != "token":
                    np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

CONFIGS = {"concat-tnet": dict(fusion="concat", use_tnet=True),
           "sum": dict(fusion="sum", use_tnet=False)}


def _inputs(seed, b=B):
    """Images and point clouds, each cloud with its own scale and offset
    (clouds alike make the max-pooled features alike across the batch)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, P, 3)) * rng.uniform(0.5, 2, (b, 1, 1)) + rng.normal(size=(b, 1, 3))
    return rng.normal(size=(b, S, S, 3)).astype(np.float32), pts.astype(np.float32)


@pytest.fixture(scope="module")
def experts():
    """{config: (JAX NuScenesExpert, perturbed numpy variables)}."""
    from automoe_tpu.models import NuScenesExpert

    out = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        model = NuScenesExpert(num_queries=Q, use_lidar=True, **kw)
        x, pts = _inputs(0)
        v = jax.device_get(jax.jit(model.init)(jax.random.key(i), {"image": x, "lidar": pts}))
        rng = np.random.default_rng(30 + i)
        v = {"params": _perturb_norms(v["params"], rng),
             "batch_stats": _perturb_norms(v["batch_stats"], rng)}
        out[name] = (model, _point_stats_of_data(v, kw, pts, rng))
    return out


def _point_stats_of_data(variables, kw, pts, rng):
    """The PointNet's running statistics set near the batch statistics of
    `pts` (float64; the mean moved by N(0, 0.1) standard deviations, the
    variance times U(0.8, 1.2)), as a trained model's are near its data's:
    perturbed init statistics leave the eval-mode activations uncentred,
    and the outputs grow to ~400, where float32 keeps ~1e-7 of that scale
    and small entries miss atol 1e-5 on both sides."""
    m = _port_expert(variables, **kw).double().train()
    for mod in m.lidar_backbone.modules():
        if isinstance(mod, torch.nn.BatchNorm1d):
            mod.momentum = 1.0
    with torch.no_grad():
        m.lidar_backbone(torch.from_numpy(pts).double())
    for name, mod in m.lidar_backbone.named_modules():
        if isinstance(mod, torch.nn.BatchNorm1d):
            node = variables["batch_stats"]["lidar_backbone"]
            for p in name.split("."):
                node = node[p]
            var = mod.running_var.numpy()
            node["mean"] = (mod.running_mean.numpy()
                            + rng.normal(size=var.shape) * 0.1 * np.sqrt(var)).astype(np.float32)
            node["var"] = (var * rng.uniform(0.8, 1.2, var.shape)).astype(np.float32)
    return variables


def _port_expert(variables, **kw):
    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.models import NuScenesExpert

    m = NuScenesExpert(num_queries=Q, use_lidar=True, **kw)
    m.load_state_dict(expert_state_dict_from_jax(variables, "nuscenes"), strict=True)
    return _no_dropout(m)


def _close(got, want, err_msg=""):
    """rtol 1e-4 with atol 5e-5 of the output's largest magnitude. Against
    a float64 run of the same module, float32 keeps ~2e-6 of that scale in
    eval mode on both sides and, with train-mode BatchNorm over the PointNet
    and TNet fc layers, ~6e-6 (port) and ~1.5e-5 (JAX: its E[x²]−E[x]²
    variance): a fixed atol of 1e-5 fails the smallest entries of outputs
    that reach ~4 (train) and ~400 (eval, untrained weights)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=5e-5 * float(np.abs(want).max()), err_msg=err_msg)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _stats_match(port_module, params, jax_stats, prefix=""):
    """The port module's running statistics against the JAX batch_stats
    (of the whole expert) after a train-mode forward."""
    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax

    want = _sub(expert_state_dict_from_jax({"params": params, "batch_stats": jax_stats},
                                           "nuscenes"), prefix)
    n = 0
    for k, t in port_module.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            n += 1
    assert n > 0


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-bn"])
@pytest.mark.parametrize("part", ["input_transform", "feature_transform", "pointnet"])
def test_tnet_and_pointnet_match_jax(experts, part, train):
    from automoe_tpu.models.experts import PointNet as JaxPointNet
    from automoe_tpu.models.experts import TNet as JaxTNet

    from automoe_tpu_torch.models import PointNet, TNet

    _, variables = experts["concat-tnet"]
    pv = {c: variables[c]["lidar_backbone"] for c in ("params", "batch_stats")}
    rng = np.random.default_rng(7)
    if part == "pointnet":
        jm, x = JaxPointNet(output_dim=256, use_tnet=True), _inputs(8)[1]
        pm, jv, prefix = PointNet(256, True), pv, "lidar_backbone."
    else:
        k = 3 if part == "input_transform" else 64
        x = rng.normal(size=(B, P, k)) * rng.uniform(0.5, 4, (B, 1, 1)) + rng.normal(size=(B, 1, k))
        jm, x = JaxTNet(k=k), x.astype(np.float32)
        pm, prefix = TNet(k), f"lidar_backbone.{part}."
        jv = {c: pv[c][part] for c in pv}
    sd = _port_expert(variables, fusion="concat", use_tnet=True).state_dict()
    pm.load_state_dict(_sub(sd, prefix), strict=True)
    _no_dropout(pm).train(train)
    if train:
        want, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            jv, x)
    else:
        want = jax.jit(lambda v, x: jm.apply(v, x))(jv, x)
    inp = torch.from_numpy(x) if part == "pointnet" else torch.from_numpy(x).transpose(1, 2)
    with torch.no_grad():
        got = pm(inp)
    _close(got.numpy(), want)
    if train:
        stats = jax.device_get(upd["batch_stats"])
        tree = variables["batch_stats"]
        new = {**tree, "lidar_backbone": (stats if part == "pointnet" else
                                          {**tree["lidar_backbone"], part: stats})}
        _stats_match(pm, variables["params"], new, prefix)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-bn"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_nuscenes_expert_matches_jax(experts, config, train):
    model, variables = experts[config]
    x, pts = _inputs(9)
    pm = _port_expert(variables, **CONFIGS[config]).train(train)
    if train:
        want, upd = jax.jit(lambda v, b: model.apply(v, b, train=True, deterministic=True,
                                                     mutable=["batch_stats"]))(
            variables, {"image": x, "lidar": pts})
    else:
        want = jax.jit(lambda v, b: model.apply(v, b))(variables, {"image": x, "lidar": pts})
    with torch.no_grad():
        got = pm(nchw(x), torch.from_numpy(pts))
    assert got["class_logits"].shape == (B, Q, 10) and got["bbox_preds"].shape == (B, Q, 7)
    for k in ("class_logits", "bbox_preds"):
        _close(got[k].numpy(), want[k], err_msg=k)
    if train:
        _stats_match(pm, variables["params"], jax.device_get(upd["batch_stats"]))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def test_state_dict_names_import_to_jax(experts, jax_2d):
    """The port's state dicts carry the reference names: the JAX package's
    importers turn them back into the variables they came from."""
    from automoe_tpu.ckpt.torch_import import import_nuscenes_2d_head, import_nuscenes_expert

    cases = [(import_nuscenes_expert, _port_expert(experts[c][1], **CONFIGS[c]), experts[c][1])
             for c in CONFIGS]
    cases.append((import_nuscenes_2d_head, jax_2d["port"], jax_2d["variables"]))
    for importer, port, variables in cases:
        sd = {k: v.numpy() for k, v in port.state_dict().items()}
        back = importer(sd)
        got, want = _flat(back), _flat(variables)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


# ---------------------------------------------------------------------------
# losses and matching
# ---------------------------------------------------------------------------

def _set_inputs(seed, regime="diverse", D=7):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, Q, 10)).astype(np.float32)
    if regime == "degenerate":  # clustered predictions: bidding wars
        preds = (rng.normal(size=(B, 1, D)) + rng.normal(size=(B, Q, D)) * 1e-3)
    else:
        preds = rng.normal(size=(B, Q, D)) * 3
    boxes = rng.normal(size=(B, N, D)) * 3
    if D == 4:
        preds, boxes = np.abs(preds) + 0.5, np.abs(boxes) + 0.5
    labels = rng.integers(0, 10, (B, N)).astype(np.int32)
    labels[0, -1] = -1
    boxes[0, -1] = -1.0
    return logits, preds.astype(np.float32), boxes.astype(np.float32), labels


@pytest.mark.parametrize("matchers,regime", [
    (("auction", "auction"), "diverse"),
    (("auction_kernel", "auction_pallas"), "diverse"),
    (("auction_kernel", "auction_pallas"), "degenerate"),
    (("auction_kernel:4", "auction_pallas:4"), "degenerate"),
], ids=["auction", "kernel-diverse", "kernel-degenerate", "kernel-escalated"])
def test_nuscenes_set_loss_matches_jax(matchers, regime):
    from automoe_tpu.losses import nuscenes_set_loss as jax_loss

    from automoe_tpu_torch.losses import nuscenes_set_loss

    arrs = _set_inputs(3, regime)
    want = jax_loss(*map(jnp.asarray, arrs), matcher=matchers[1])
    got = nuscenes_set_loss(*map(torch.from_numpy, arrs), matcher=matchers[0])
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["query_idx"].numpy()[v], np.asarray(want["query_idx"])[v])
    for k in ("loss", "class_loss", "bbox_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_matchers_match_jax_hungarian(seed):
    """The 2D fine-tune's exact match: scipy (the CPU path) and K2's plain
    version alone (the card's path, max_iters=0) against optax's Hungarian."""
    from automoe_tpu.ops.matching import hungarian_match as jax_hungarian

    from automoe_tpu_torch.losses.detection import get_matcher

    arrs = _set_inputs(seed, D=4)
    want, wv = map(np.asarray, jax_hungarian(*map(jnp.asarray, arrs)))
    for name in ("hungarian", "auction_kernel:0"):
        qi, valid = get_matcher(name)(*map(torch.from_numpy, arrs))
        np.testing.assert_array_equal(valid.numpy(), wv)
        np.testing.assert_array_equal(qi.numpy()[wv], want[wv], err_msg=name)


@pytest.fixture(scope="module")
def jax_2d():
    """JAX NuScenesImage2DHead with perturbed norms and the port's head on
    the same weights."""
    from automoe_tpu.train.workloads import carla_nuscenes_2d_workload

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.workloads import carla_nuscenes_2d_workload as port_workload

    wl = carla_nuscenes_2d_workload(num_queries=Q, image_size=S, box_cap=N)
    v = jax.device_get(wl.init_variables(jax.random.key(4)))
    rng = np.random.default_rng(44)
    variables = {"params": _perturb_norms(v["params"], rng),
                 "batch_stats": _perturb_norms(v["batch_stats"], rng)}
    pwl = port_workload(num_queries=Q)
    port = pwl.init_model(0, "cpu").eval()
    port.load_state_dict(expert_state_dict_from_jax(variables, "nuscenes_2d"), strict=True)
    return {"wl": wl, "variables": variables, "port": port}


@pytest.mark.parametrize("matcher", [None, "auction_kernel:0"], ids=["cpu-default", "k2-plain"])
def test_nuscenes_2d_loss_matches_jax(jax_2d, matcher):
    """The 2D workload's eval-mode loss on the same weights and batch
    (xyxy pixel boxes, one padded slot): JAX's exact Hungarian against the
    port's CPU default (scipy) and K2's plain version."""
    from automoe_tpu_torch.train.workloads import carla_nuscenes_2d_workload

    rng = np.random.default_rng(12)
    xy1 = rng.uniform(0, 0.4, (B, N, 2)) * S
    boxes = np.concatenate([xy1, xy1 + rng.uniform(4, 20, (B, N, 2))], -1).astype(np.float32)
    labels = rng.integers(0, 10, (B, N)).astype(np.int32)
    labels[1, -1] = -1
    batch = {"image": _inputs(13)[0], "bboxes": boxes, "labels": labels}
    wl = jax_2d["wl"]
    want, (metrics, _) = jax.jit(lambda v, b: wl.loss_fn(v["params"], v["batch_stats"], b,
                                                         jax.random.key(0), False))(
        jax_2d["variables"], batch)
    out = jax.jit(lambda v, x: wl.model.apply(v, x))(jax_2d["variables"], batch["image"])
    pwl = carla_nuscenes_2d_workload(num_queries=Q, matcher=matcher)
    with torch.no_grad():
        got, pm = pwl.loss_fn(jax_2d["port"].eval(), {k: torch.from_numpy(v)
                                                      for k, v in batch.items()}, False)
        pout = jax_2d["port"](nchw(batch["image"]))
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(out[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    for k in ("class_loss", "bbox_loss"):
        np.testing.assert_allclose(float(pm[k]), float(metrics[k]), rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the LiDAR workload's trajectory
# ---------------------------------------------------------------------------

def _nus_batches(seed=111, n=N_STEPS):
    """Batches whose exact matches have no near-tie along the trajectory
    (outputs moved by 3e-5 relative noise keep every match in 30 draws a
    step). Most seeds have one: from seeds 21, 41 and 61 the two packages'
    forwards, ~1e-5 apart, pick different near-optimal queries for one
    target at step 2, and the trajectories fork there (as detection ones
    do under AdamW)."""
    out = []
    for i in range(n):
        x, pts = _inputs(seed + i)
        logits, _, boxes, labels = _set_inputs(seed + i)
        out.append({"image": x, "lidar": pts, "boxes": boxes, "labels": labels})
    return out


@pytest.fixture(scope="module")
def trajectories(experts, module_tmp):
    """N_STEPS SGD steps of the LiDAR nuScenes workload (use_tnet, concat)
    in both packages from the same weights, dropout off: JAX with
    auction_pallas (interpret mode), the port with auction_kernel (its
    plain version on the CPU)."""
    import optax
    from automoe_tpu.losses import nuscenes_set_loss
    from automoe_tpu.train.state import make_optimizer

    from automoe_tpu_torch.ckpt import expert_state_dict_from_jax
    from automoe_tpu_torch.train.loop import TrainConfig, Trainer
    from automoe_tpu_torch.train.workloads import nuscenes_workload

    model, init = experts["concat-tnet"]

    def loss(params, stats, batch):
        out, upd = model.apply({"params": params, "batch_stats": stats},
                               {"image": batch["image"], "lidar": batch["lidar"]}, train=True,
                               deterministic=True, mutable=["batch_stats"])
        res = nuscenes_set_loss(out["class_logits"], out["bbox_preds"], batch["boxes"],
                                batch["labels"], matcher="auction_pallas")
        return res["loss"], upd["batch_stats"]

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    tx = make_optimizer(learning_rate=LR, weight_decay=0.0, total_steps=N_STEPS,
                        optimizer="sgd", schedule="cosine")
    update = jax.jit(tx.update)
    params, stats = init["params"], init["batch_stats"]
    opt_state = tx.init(params)
    losses = []
    batches = _nus_batches()
    for batch in batches:
        (lv, stats), grads = vg(params, stats, batch)
        upd, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(lv))
    final = {"params": jax.device_get(params), "batch_stats": jax.device_get(stats)}

    tmp = module_tmp("traj")
    ptr = Trainer(nuscenes_workload(num_queries=Q, use_lidar=True, use_tnet=True,
                                    matcher="auction_kernel"), batches, batches,
                  TrainConfig(epochs=1, learning_rate=LR, weight_decay=0.0, optimizer="sgd",
                              run_name="p", runs_root=str(tmp / "runs"),
                              ckpt_root=str(tmp / "ckpt"), device="cpu", log_every=1))
    ptr.model.load_state_dict(expert_state_dict_from_jax(init, "nuscenes"), strict=True)
    _no_dropout(ptr.model)
    ptr.train_epoch(0)
    ptr.logger.close()
    recs = map(json.loads, (tmp / "runs" / "nuscenes_p" / "metrics.jsonl").read_text()
               .splitlines())
    return {"jax_losses": losses, "port_losses": [r["train/loss"] for r in recs
                                                  if "train/loss" in r],
            "want": expert_state_dict_from_jax(final, "nuscenes"),
            "port": {k: v.detach() for k, v in ptr.model.state_dict().items()}}


def test_lidar_trajectory_losses_match_jax(trajectories):
    assert len(trajectories["port_losses"]) == N_STEPS
    np.testing.assert_allclose(trajectories["port_losses"], trajectories["jax_losses"],
                               rtol=1e-4)


@pytest.mark.parametrize("group", ["image_backbone.", "image_projection.",
                                   "lidar_backbone.input_transform.",
                                   "lidar_backbone.feature_transform.", "lidar_backbone.conv",
                                   "lidar_backbone.fc", "lidar_backbone.bn", "query_embed.",
                                   "decoder.", "class_head.", "bbox_head."])
def test_lidar_trajectory_state_matches_jax(trajectories, group):
    port, want = trajectories["port"], trajectories["want"]
    keys = [k for k in port if k.startswith(group) and not k.endswith("num_batches_tracked")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


class _Fixed(torch.nn.Module):
    """A stand-in expert that returns given outputs, batch by batch."""

    def __init__(self, outs):
        super().__init__()
        self.outs = iter(outs)
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def forward(self, image, lidar):
        return {k: torch.from_numpy(v) for k, v in next(self.outs).items()}


def test_evaluate_nuscenes_matches_jax():
    """The val loss (exact matching) averaged over three batches, on the
    same expert outputs fed to both packages (the forward's parity is
    tested above): rtol 1e-5."""
    from automoe_tpu.evals.nuscenes import evaluate_nuscenes as jax_evaluate

    from automoe_tpu_torch.evals.nuscenes import evaluate_nuscenes

    def sized(b):  # positive sizes: an untrained head's negative ones make the
        # BEV GIoU costs ~1e10, where float32 ties let exact solvers differ
        b = b.copy()
        b[..., 3:6] = np.abs(b[..., 3:6]) + 0.5
        return b

    batches, outs = [], []
    for seed in range(3):
        logits, preds, boxes, labels = _set_inputs(40 + seed)
        preds, boxes = sized(preds), sized(boxes)
        x, pts = _inputs(seed, b=B)
        batches.append({"image": x, "lidar": pts, "boxes": boxes, "labels": labels})
        outs.append({"class_logits": logits, "bbox_preds": preds})
    it = iter(outs)
    want = jax_evaluate(lambda v, b: next(it), None, batches)
    got = evaluate_nuscenes(_Fixed(outs), batches)
    assert sorted(got) == sorted(want) == ["val_loss"]
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [["--use-lidar", "--use-tnet"],
                                   ["--use-lidar", "--fusion", "sum"], []],
                         ids=["lidar-tnet-concat", "lidar-sum", "camera"])
def test_nuscenes_cli_on_cpu(nus_root, tmp_path, extra):
    from automoe_tpu_torch.ckpt import load_checkpoint
    from automoe_tpu_torch.train.cli import main

    res = main(["nuscenes", "--data-root", str(nus_root), "--image-size", str(S),
                "--num-queries", str(Q), "--lidar-cap", str(P), "--box-cap", str(N),
                "--batch-size", "2", "--epochs", "1", "--num-workers", "1",
                "--runs-root", str(tmp_path / "runs"), "--ckpt-root", str(tmp_path / "ckpt"),
                "--device", "cpu", *extra])
    assert np.isfinite(res["best_val_loss"])
    sd = load_checkpoint(tmp_path / "ckpt" / "nuscenes" / "run" / "best.pt")["model_state_dict"]
    assert any(k.startswith("lidar_backbone.input_transform.") for k in sd) == (
        "--use-tnet" in extra)
    assert sd["query_embed.weight"].shape == (Q, 512 if extra[:2] == ["--use-lidar", "--use-tnet"]
                                              else 256)
    shutil.rmtree(tmp_path / "ckpt")  # ~0.5 GB of weights and moments


def test_nuscenes_2d_cli_on_cpu(tmp_path):
    from automoe_tpu_torch.tools.synth import synth_carla_detection
    from automoe_tpu_torch.train.cli import main

    root = synth_carla_detection(tmp_path / "data", n_per_split={"train": 4, "val": 3},
                                 size=S, max_boxes=3)
    res = main(["nuscenes-2d", "--data-root", str(root), "--image-size", str(S),
                "--num-queries", str(Q), "--box-cap", str(N), "--batch-size", "2",
                "--epochs", "2", "--num-workers", "1", "--runs-root", str(tmp_path / "runs"),
                "--ckpt-root", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert np.isfinite(res["best_val_loss"])
    recs = [json.loads(line) for line in (tmp_path / "runs" / "carla_nuscenes_2d_run" /
                                          "metrics.jsonl").read_text().splitlines()]
    assert len([r for r in recs if "val/loss" in r]) == 2
    shutil.rmtree(tmp_path / "ckpt")
