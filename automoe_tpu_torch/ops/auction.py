"""The vectorised auction matcher with greedy completion (port of
automoe_tpu/ops/auction.py): the default matcher off the card, as the JAX
package's `default_matcher()` picks it off the accelerator.

A single ε-phase (ε = spread·eps_fraction/N) where every unassigned target
bids at once; persons the capped phase leaves unassigned take their best
free object, row by row. API-compatible with `hungarian_match`.
"""
from __future__ import annotations

import torch

from automoe_tpu_torch.ops.matching import match_cost_matrix

_NEG = -1e9


def _top2(values: torch.Tensor):
    """(first argmax, max, second-largest value) over the last axis, as
    jax.lax.top_k(values, 2) gives them."""
    best = values.argmax(-1, keepdim=True)
    v1 = torch.gather(values, -1, best)
    masked = values.scatter(-1, best, float("-inf"))
    return best[..., 0], v1[..., 0], masked.amax(-1)


def _auction_phase(benefit, valid, price, eps, max_iters):
    """One ε-phase from `price`: benefit [B,N,Q], valid [B,N], price [B,Q],
    eps [B] → (price, person_obj [B,N])."""
    B, N, Q = benefit.shape
    dev = benefit.device
    if Q == 1:
        vals = torch.where(valid, benefit[..., 0], torch.full_like(benefit[..., 0], _NEG))
        best = vals.argmax(1)
        hit = (torch.arange(N, device=dev)[None, :] == best[:, None]) & valid
        return price, torch.where(hit, 0, -1).int()
    iota_q = torch.arange(Q, device=dev)
    person_obj = torch.full((B, N), -1, dtype=torch.int32, device=dev)
    neg = torch.tensor(_NEG, dtype=benefit.dtype, device=dev)
    for _ in range(max_iters):
        if not bool(((person_obj < 0) & valid).any()):
            break
        values = benefit - price[:, None, :]
        best_obj, v1, v2 = _top2(values)
        bid_inc = v1 - v2 + eps[:, None]
        bidding = (person_obj < 0) & valid
        onehot = iota_q == best_obj[..., None]
        bids = torch.where(bidding[..., None] & onehot, bid_inc[..., None], neg)
        win_val, win_person = bids.amax(1), bids.argmax(1)  # first max over persons
        has_bid = win_val > _NEG * 0.5
        price = torch.where(has_bid, price + win_val, price)
        lost = (person_obj >= 0) & torch.gather(has_bid, 1, person_obj.clamp(min=0).long())
        person_obj = torch.where(lost, -1, person_obj)
        # award: the winner of object j gets j (each person bids one object)
        award = torch.where(has_bid[:, :, None]
                            & (torch.arange(N, device=dev) == win_person[:, :, None]),
                            iota_q[None, :, None], -1)  # [B,Q,N]
        new_assign = award.max(1).values
        person_obj = torch.where(new_assign >= 0, new_assign, person_obj).int()
    return price, person_obj


def _greedy_complete(benefit, valid, person_obj):
    """Every still-unassigned valid person takes its best free object,
    row by row (a no-op when the phase converged)."""
    B, N, Q = benefit.shape
    iota_q = torch.arange(Q, device=benefit.device)
    taken = ((iota_q == person_obj[..., None]) & (person_obj >= 0)[..., None]).any(1)
    person_obj = person_obj.clone()
    for n in range(N):
        needs = (person_obj[:, n] < 0) & valid[:, n]
        vals = torch.where(taken, torch.full_like(benefit[:, n], _NEG), benefit[:, n])
        best = vals.argmax(1)
        free = vals.amax(1) > _NEG * 0.5
        assign = needs & free
        person_obj[:, n] = torch.where(assign, best.int(), person_obj[:, n])
        taken = taken | (assign[:, None] & (iota_q == best[:, None]))
    return person_obj


def _auction_solve(benefit, valid, *, eps_fraction=1e-2, max_iters=1000):
    """Single-phase auction: benefit [B,N,Q] (maximize), valid [B,N] →
    assigned object per person [B,N] (-1 where none)."""
    B, N, Q = benefit.shape
    benefit = torch.where(valid[..., None], benefit, torch.zeros_like(benefit))
    spread = torch.clamp(benefit.amax((1, 2)) - benefit.amin((1, 2)), min=1e-3)
    eps = spread * eps_fraction / max(N, 1)
    price = torch.zeros(B, Q, dtype=benefit.dtype, device=benefit.device)
    _, person_obj = _auction_phase(benefit, valid, price, eps, max_iters)
    if Q > 1:
        person_obj = _greedy_complete(benefit, valid, person_obj)
    return person_obj


@torch.no_grad()
def auction_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor, *,
                  cost_class: float = 1.0, cost_bbox: float = 5.0, cost_giou: float = 2.0,
                  eps_fraction: float = 1e-2, max_iters: int = 1000):
    """Near-optimal drop-in for hungarian_match: (query_idx [B,N] int32,
    valid [B,N] bool); a target left unassigned (only when #targets > Q)
    is dropped, never clipped onto query 0."""
    valid = tgt_labels >= 0
    cost = match_cost_matrix(pred_logits.detach(), pred_boxes.detach(), tgt_boxes,
                             tgt_labels, cost_class=cost_class, cost_bbox=cost_bbox,
                             cost_giou=cost_giou)
    benefit = -cost.transpose(1, 2).float()
    query_idx = _auction_solve(benefit, valid, eps_fraction=eps_fraction,
                               max_iters=max_iters)
    valid = valid & (query_idx >= 0)
    return torch.clamp(query_idx, min=0).int(), valid
