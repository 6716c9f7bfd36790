"""The port's matching path against the JAX package on the CPU: box
geometry, masked losses and the matching cost (rtol 1e-5), the plain
version of the auction kernel against `auction_solve_pallas` in interpret
mode (identical int outputs), the vectorised auction against JAX's, and
the detection set loss for each matcher. All JAX results come from one
module-scoped fixture; inputs are numpy draws from fixed seeds."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import tests.torch_port_common  # noqa: F401  (caps torch's intra-op threads)

# (B, Q, N) of tests/test_pallas_auction.py's sweep
SOLVE_SHAPES = [(2, 16, 8), (4, 64, 48), (2, 64, 16), (1, 256, 32), (3, 36, 36)]
MATCHERS = ["hungarian", "auction", "auction_kernel", "auction_pallas:64"]
# ((B, Q, N), max_iters) for escalate=False: caps that leave rows for the
# greedy completion, and N > Q
GREEDY_CASES = [((4, 64, 48), 3), ((2, 16, 8), 1), ((3, 36, 36), 2), ((3, 8, 12), 4)]


def _solve_inputs(B, Q, N, seed):
    rng = np.random.default_rng(seed)
    benefit = -rng.uniform(0, 10, (B, N, Q)).astype(np.float32)
    valid = np.ones((B, N), bool)
    if B > 1:
        valid[1, N // 2:] = False  # partly invalid
    if B > 2:
        valid[2] = False  # a whole element invalid
    spread = np.maximum(benefit.max((1, 2)) - benefit.min((1, 2)), 1e-3)
    eps = (spread * 1e-6 / N).astype(np.float32)
    return benefit, valid, eps


def _degenerate(B=3, Q=64, N=48, C=10, seed=4242):
    """Clustered predictions of an untrained detector (near-tie costs)."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(1, 1, C)) + 1e-3 * rng.normal(size=(B, Q, C))).astype(np.float32)
    boxes = np.clip(np.array([0.4, 0.4, 0.6, 0.6]) + 1e-3 * rng.normal(size=(B, Q, 4)),
                    0, 1).astype(np.float32)
    tb = rng.uniform(0.1, 0.9, (B, N, 4)).astype(np.float32)
    tl = rng.integers(0, C, (B, N)).astype(np.int32)
    tl[0, N // 2:] = -1
    return logits, boxes, tb, tl


def _detection_inputs(seed, B=2, h=4, N=6, C=10):
    """NHWC dense outputs with well-separated matching costs: each target
    sits on its own cell, whose box and class agree with it."""
    rng = np.random.default_rng(seed)
    Q = h * h
    logits = rng.normal(size=(B, Q, C)).astype(np.float32)
    deltas = rng.uniform(0.05, 0.95, (B, Q, 4)).astype(np.float32)
    gt = np.zeros((B, N, 4), np.float32)
    labels = np.full((B, N), -1, np.int32)
    for b in range(B):
        cells = rng.choice(Q, N - 1, replace=False)
        for n, q in enumerate(cells):
            x1, y1 = rng.uniform(0.05, 0.5, 2)
            w, hh = rng.uniform(0.1, 0.4, 2)
            gt[b, n] = (x1, y1, x1 + w, y1 + hh)
            labels[b, n] = rng.integers(0, C)
            deltas[b, q] = (x1 + w / 2, y1 + hh / 2, w, hh) + rng.normal(0, 0.01, 4)
            logits[b, q, labels[b, n]] += 4.0
    return logits.reshape(B, h, h, C), deltas.reshape(B, h, h, 4), gt, labels


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX result the tests compare with, computed once."""
    from automoe_tpu.losses.detection import detection_set_loss
    from automoe_tpu.ops import boxes as jb
    from automoe_tpu.ops import masked as jm
    from automoe_tpu.ops.auction import auction_match
    from automoe_tpu.ops.matching import match_cost_matrix
    from automoe_tpu.ops.pallas_auction import auction_match_pallas, auction_solve_pallas

    rng = np.random.default_rng(0)
    ref = {}
    b1 = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    b2 = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    b1[:, 2:] += b1[:, :2]
    b2[:, 2:] += b2[:, :2]
    b7 = rng.normal(size=(2, 6, 7)).astype(np.float32)
    ref["boxes_in"] = (b1, b2, b7)
    ref["box_iou"] = np.asarray(jb.box_iou(b1, b2))
    ref["giou"] = np.asarray(jb.generalized_box_iou(b1, b2))
    ref["cxcywh"] = np.asarray(jb.box_convert(b1, "xyxy", "cxcywh"))
    ref["xyxy"] = np.asarray(jb.box_convert(b1, "cxcywh", "xyxy"))
    ref["bev"] = np.asarray(jb.bev_from_3d(b7))

    logits = rng.normal(size=(3, 12, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (3, 12)).astype(np.int32)
    labels[0, :4] = 5  # ignored
    none = np.full((3, 12), 5, np.int32)  # nothing matched
    pred, tgt = rng.normal(size=(2, 3, 12, 4)).astype(np.float32) * 2
    mask = rng.uniform(size=(3, 12)) < 0.5
    ref["masked_in"] = (logits, labels, none, pred, tgt, mask)
    ref["ce"] = float(jm.masked_cross_entropy(logits, labels, 5))
    ref["ce_none"] = float(jm.masked_cross_entropy(logits, none, 5))
    ref["sl1"] = np.asarray(jm.smooth_l1(pred, tgt))
    for red in ("mean", "sum"):
        ref[f"msl1_{red}"] = float(jm.masked_smooth_l1(pred, tgt, mask, reduction=red))
        ref[f"msl1_{red}_none"] = float(
            jm.masked_smooth_l1(pred, tgt, np.zeros_like(mask), reduction=red))

    cost_in = {}
    for d in (4, 7):
        pl, pb = rng.normal(size=(2, 9, 6)).astype(np.float32), rng.uniform(0.1, 0.9, (2, 9, d))
        tb, tl = rng.uniform(0.1, 0.9, (2, 5, d)), rng.integers(-1, 6, (2, 5)).astype(np.int32)
        cost_in[d] = (pl, pb.astype(np.float32), tb.astype(np.float32), tl)
        ref[f"cost{d}"] = np.asarray(jax.vmap(match_cost_matrix)(*cost_in[d]))
    ref["cost_in"] = cost_in

    for i, shape in enumerate(SOLVE_SHAPES):
        benefit, valid, eps = _solve_inputs(*shape, seed=100 + i)
        for mi in (0, 128):
            ref[("solve", shape, mi)] = np.asarray(auction_solve_pallas(
                jnp.asarray(benefit), jnp.asarray(valid), jnp.asarray(eps),
                max_iters=mi, interpret=True))
    for i, (shape, mi) in enumerate(GREEDY_CASES):
        benefit, valid, eps = _solve_inputs(*shape, seed=200 + i)
        ref[("greedy_solve", shape, mi)] = np.asarray(auction_solve_pallas(
            jnp.asarray(benefit), jnp.asarray(valid), jnp.asarray(eps), max_iters=mi,
            interpret=True, escalate=False))
    q1 = np.array([[[0.9], [0.1], [0.5]], [[0.2], [0.7], [0.7]]], np.float32)
    q1_valid = np.array([[True, True, True], [False, True, True]])
    ref["q1"] = np.asarray(auction_solve_pallas(q1, q1_valid, np.full(2, 0.01, np.float32),
                                                interpret=True))
    ref["q1_none"] = np.asarray(auction_solve_pallas(q1, np.zeros((2, 3), bool),
                                                     np.full(2, 0.01, np.float32),
                                                     interpret=True))

    deg = _degenerate()
    ref["degenerate"] = deg
    ref["deg_cost"] = np.asarray(jax.vmap(match_cost_matrix)(*deg))
    for mi in (0, 128):
        qi, v = auction_match_pallas(*deg, max_iters=mi, interpret=True)
        ref[("deg_match", mi)] = (np.asarray(qi), np.asarray(v))

    for seed in (1, 2):
        logits, deltas, gt, lab = _detection_inputs(seed)
        ref[("det_in", seed)] = (logits, deltas, gt, lab)
        qi, v = auction_match(logits.reshape(2, 16, 10), deltas.reshape(2, 16, 4),
                              jnp.asarray(gt), jnp.asarray(lab))
        ref[("greedy", seed)] = (np.asarray(qi), np.asarray(v))
        for m in MATCHERS:
            res = detection_set_loss(logits, deltas, gt, lab, num_classes=10,
                                     matcher=m.replace("auction_kernel", "auction_pallas"))
            ref[("det", seed, m)] = {k: np.asarray(v) for k, v in res.items()}
        res = detection_set_loss(logits, deltas, gt, lab, num_classes=10, matcher="hungarian",
                                 bbox_reduction="sum")
        ref[("det_sum", seed)] = {k: np.asarray(v) for k, v in res.items()}
    return ref


def test_box_ops_match_jax(jax_ref):
    from automoe_tpu_torch.ops import boxes

    b1, b2, b7 = map(torch.from_numpy, jax_ref["boxes_in"])
    for got, want in ((boxes.box_iou(b1, b2), "box_iou"),
                      (boxes.generalized_box_iou(b1, b2), "giou"),
                      (boxes.box_convert(b1, "xyxy", "cxcywh"), "cxcywh"),
                      (boxes.box_convert(b1, "cxcywh", "xyxy"), "xyxy"),
                      (boxes.bev_from_3d(b7), "bev")):
        np.testing.assert_allclose(got.numpy(), jax_ref[want], rtol=1e-5, atol=1e-6,
                                   err_msg=want)


def test_masked_losses_match_jax(jax_ref):
    from automoe_tpu_torch.ops import masked

    logits, labels, none, pred, tgt, mask = map(torch.from_numpy, jax_ref["masked_in"])
    np.testing.assert_allclose(float(masked.masked_cross_entropy(logits, labels, 5)),
                               jax_ref["ce"], rtol=1e-5)
    # nothing matched: 0, as in JAX (F.cross_entropy(ignore_index) gives NaN)
    assert float(masked.masked_cross_entropy(logits, none, 5)) == jax_ref["ce_none"] == 0.0
    np.testing.assert_allclose(masked.smooth_l1(pred, tgt).numpy(), jax_ref["sl1"], rtol=1e-5)
    for red in ("mean", "sum"):
        np.testing.assert_allclose(float(masked.masked_smooth_l1(pred, tgt, mask, reduction=red)),
                                   jax_ref[f"msl1_{red}"], rtol=1e-5)
        got = float(masked.masked_smooth_l1(pred, tgt, torch.zeros_like(mask), reduction=red))
        assert got == jax_ref[f"msl1_{red}_none"] == 0.0


@pytest.mark.parametrize("d", [4, 7])
def test_match_cost_matrix_matches_jax(jax_ref, d):
    from automoe_tpu_torch.ops.matching import match_cost_matrix

    got = match_cost_matrix(*map(torch.from_numpy, jax_ref["cost_in"][d]))
    np.testing.assert_allclose(got.numpy(), jax_ref[f"cost{d}"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("max_iters", [0, 128])
@pytest.mark.parametrize("shape", SOLVE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_auction_plain_equals_pallas_kernel(jax_ref, shape, max_iters):
    """The kernel's plain version returns exactly the Pallas kernel's
    assignment (max_iters=0: every element through the JV escalation)."""
    from automoe_tpu_torch.ops.auction_kernel import auction_solve

    benefit, valid, eps = _solve_inputs(*shape, seed=100 + SOLVE_SHAPES.index(shape))
    got = auction_solve(torch.from_numpy(benefit), torch.from_numpy(valid),
                        torch.from_numpy(eps), max_iters=max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jax_ref[("solve", shape, max_iters)])


@pytest.mark.parametrize("shape,max_iters", GREEDY_CASES,
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_auction_greedy_plain_equals_pallas_kernel(jax_ref, shape, max_iters):
    """escalate=False: the capped auction's leftover rows take their best
    free object row by row, exactly as the Pallas kernel's greedy branch."""
    from automoe_tpu_torch.ops.auction_kernel import auction_phase_plain, auction_solve

    benefit, valid, eps = _solve_inputs(*shape, seed=200 + GREEDY_CASES.index((shape, max_iters)))
    b, v, e = map(torch.from_numpy, (np.where(valid[..., None], benefit, 0), valid, eps))
    left, _ = auction_phase_plain(b, v, e, max_iters)
    assert bool(((left < 0) & v).any())  # the greedy branch has rows to place
    got = auction_solve(torch.from_numpy(benefit), v, e, max_iters=max_iters, escalate=False)
    np.testing.assert_array_equal(got.numpy(), jax_ref[("greedy_solve", shape, max_iters)])


def test_auction_counts_plain():
    """The loop counts the bench tool prints: no rounds at cap 0 and every
    element with a valid row through JV, at least one scan per valid row;
    uncapped, every element converges in the auction."""
    from automoe_tpu_torch.ops.auction_kernel import auction_counts_plain

    benefit, valid, eps = map(torch.from_numpy, _solve_inputs(3, 16, 8, seed=7))
    c0 = auction_counts_plain(benefit, valid, eps, 0)
    assert c0["rounds"].tolist() == [0, 0, 0]
    assert c0["escalated"].tolist() == [True, True, False]
    assert (c0["jv_scans"] >= valid.sum(1)).all() and c0["jv_scans"][2] == 0
    c1 = auction_counts_plain(benefit, valid, eps, 1000)
    assert not c1["escalated"].any() and (c1["jv_scans"] == 0).all()
    assert (c1["rounds"][:2] >= 1).all() and c1["rounds"][2] == 0


def test_auction_single_query_equals_pallas(jax_ref):
    from automoe_tpu_torch.ops.auction_kernel import auction_solve

    q1 = torch.tensor([[[0.9], [0.1], [0.5]], [[0.2], [0.7], [0.7]]])
    valid = torch.tensor([[True, True, True], [False, True, True]])
    eps = torch.full((2,), 0.01)
    np.testing.assert_array_equal(auction_solve(q1, valid, eps).numpy(), jax_ref["q1"])
    np.testing.assert_array_equal(auction_solve(q1, torch.zeros(2, 3, dtype=torch.bool),
                                                eps).numpy(), jax_ref["q1_none"])


@pytest.mark.parametrize("max_iters", [0, 128])
def test_auction_match_kernel_exact_on_near_ties(jax_ref, max_iters):
    """Clustered predictions: the cost matrices of the two packages differ
    in the last bits, so near-tie assignments may differ; both must be
    optimal (total cost within 1e-4 of scipy's) and drop no target."""
    from automoe_tpu_torch.ops.auction_kernel import auction_match_kernel

    deg = jax_ref["degenerate"]
    qi, valid = auction_match_kernel(*map(torch.from_numpy, deg), max_iters=max_iters)
    qi, valid = qi.numpy(), valid.numpy()
    jqi, jvalid = jax_ref[("deg_match", max_iters)]
    np.testing.assert_array_equal(valid, jvalid)
    for b in range(len(qi)):
        rows = np.where(valid[b])[0]
        cost = jax_ref["deg_cost"][b].astype(np.float64)[:, rows]
        assert len(set(qi[b][rows].tolist())) == len(rows)
        ri, ci = linear_sum_assignment(cost)
        opt = cost[ri, ci].sum()
        assert abs(cost[qi[b][rows], np.arange(len(rows))].sum() - opt) <= 1e-4
        assert abs(cost[jqi[b][rows], np.arange(len(rows))].sum() - opt) <= 1e-4


@pytest.mark.parametrize("seed", [1, 2])
def test_greedy_auction_matches_jax(jax_ref, seed):
    from automoe_tpu_torch.ops.auction import auction_match

    logits, deltas, gt, lab = jax_ref[("det_in", seed)]
    qi, valid = auction_match(torch.from_numpy(logits).reshape(2, 16, 10),
                              torch.from_numpy(deltas).reshape(2, 16, 4),
                              torch.from_numpy(gt), torch.from_numpy(lab))
    np.testing.assert_array_equal(qi.numpy(), jax_ref[("greedy", seed)][0])
    np.testing.assert_array_equal(valid.numpy(), jax_ref[("greedy", seed)][1])


@pytest.mark.parametrize("matcher", MATCHERS)
@pytest.mark.parametrize("seed", [1, 2])
def test_detection_set_loss_matches_jax(jax_ref, seed, matcher):
    """NCHW port outputs flatten to the JAX query order: same matches,
    same targets, losses within 1e-5."""
    from automoe_tpu_torch.losses.detection import detection_set_loss

    logits, deltas, gt, lab = jax_ref[("det_in", seed)]
    got = detection_set_loss(_nchw(logits), _nchw(deltas), torch.from_numpy(gt),
                             torch.from_numpy(lab), num_classes=10, matcher=matcher)
    want = jax_ref[("det", seed, matcher)]
    for k in ("query_idx", "valid", "target_classes"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["target_boxes"].numpy(), want["target_boxes"], rtol=1e-6)
    for k in ("loss", "class_loss", "bbox_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("seed", [1, 2])
def test_detection_eval_sum_and_metrics_match_jax(jax_ref, seed):
    from automoe_tpu.evals.detection import matched_iou_recall as jax_miou

    from automoe_tpu_torch.evals.detection import matched_iou_recall
    from automoe_tpu_torch.losses.detection import detection_set_loss

    logits, deltas, gt, lab = jax_ref[("det_in", seed)]
    got = detection_set_loss(_nchw(logits), _nchw(deltas), torch.from_numpy(gt),
                             torch.from_numpy(lab), num_classes=10, matcher="hungarian",
                             bbox_reduction="sum")
    np.testing.assert_allclose(float(got["loss"]), float(jax_ref[("det_sum", seed)]["loss"]),
                               rtol=1e-5)
    pred = deltas.reshape(2, 16, 4)
    want = jax_miou(pred, gt, jax_ref[("det_sum", seed)]["query_idx"],
                    jax_ref[("det_sum", seed)]["valid"])
    mine = matched_iou_recall(torch.from_numpy(pred), torch.from_numpy(gt), got["query_idx"],
                              got["valid"])
    for a, b in zip(mine, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    assert float(mine[0].min()) > 0.5  # the matched boxes do overlap their targets


def test_matcher_names():
    from automoe_tpu_torch.losses.detection import get_matcher
    from automoe_tpu_torch.ops.auction_kernel import auction_match_kernel
    from automoe_tpu_torch.ops.matching import exact_match

    assert get_matcher("auction_pallas") is auction_match_kernel
    assert get_matcher("auction_kernel:7").keywords == {"max_iters": 7}
    assert get_matcher("hungarian") is exact_match
    with pytest.raises(ValueError):
        get_matcher("hungarian:5")
    with pytest.raises(ValueError):
        get_matcher("sinkhorn")
