"""The auction matcher with its exact Jonker-Volgenant escalation, as one
hand-written CUDA kernel (csrc/auction.cu), and its plain version.

Port of automoe_tpu/ops/pallas_auction.py: K1 `_auction_kernel` (the
single-phase forward auction, one batch element per program) and K2
`_jv_exact` (exact JV from scratch for an element still unconverged at
the iteration cap), which runs inside K1's launch; with escalate=False,
K1's greedy completion takes K2's place.

`auction_solve(benefit, valid, eps, max_iters=..., escalate=...)` launches
the kernel on a CUDA tensor (or raises) and runs `auction_solve_plain` on a
CPU tensor.
The plain version is a literal transcription of the JAX kernel, vector ops
over the batch, with the f32 operations in the JAX order: kernel and plain
version return identical assignments on identical inputs.
`auction_match_kernel` is the matcher over it (the counterpart of
`auction_match_pallas`). `LAUNCHES` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from automoe_tpu_torch.ops._ext import check_cuda, load_library, raise_on

_NEG = -1e9
_INF = 1e30
#: the most dynamic shared memory a block may use on Hopper
_MAX_SMEM = 232448

LAUNCHES = {"auction_solve": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.automoe_auction_solve.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.automoe_auction_solve.restype = i
    lib.automoe_auction_smem_bytes.argtypes = [i, i]
    lib.automoe_auction_smem_bytes.restype = i


def build() -> ctypes.CDLL:
    """Compile csrc/auction.cu for sm_90a (once per process) and bind it.
    --fmad=false: no multiply-add contraction (the kernel's f32 arithmetic
    is adds and subtracts in the JAX order, written as __fadd_rn/__fsub_rn
    intrinsics as well)."""
    return load_library("automoe_auction", "auction.cu", ["--fmad=false"], bind=_bind)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _gather0(x: torch.Tensor, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """x[b, idx[b]] per row, `fill` where idx is out of range: the value of
    the JAX kernel's one-hot sum (or min) at an index that matches nothing."""
    n = x.shape[1]
    ok = (idx >= 0) & (idx < n)
    g = torch.gather(x, 1, idx.clamp(0, n - 1).long()[:, None])[:, 0]
    return torch.where(ok, g, torch.full_like(g, fill))


def auction_phase_plain(benefit, valid, eps, max_iters):
    """K1's forward auction alone (pallas_auction.py:169-217), over the
    batch: an element stops once every valid row is assigned, all stop at
    max_iters. Returns person_obj [B,N] (-1: unassigned, the rows JV then
    solves) and the rounds each element ran [B]."""
    B, N, Q = benefit.shape
    dev = benefit.device
    iota_q = torch.arange(Q, device=dev)
    iota_n = torch.arange(N, device=dev)[:, None]
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    price = torch.zeros(B, 1, Q, dtype=torch.float32, device=dev)
    person_obj = torch.full((B, N, 1), -1, dtype=torch.int32, device=dev)
    valid3 = valid[..., None]
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(max_iters):
        active = ((person_obj < 0) & valid3).any(1)[:, :, None]  # [B,1,1]
        if not bool(active.any()):
            break
        rounds += active[:, 0, 0]
        values = benefit - price
        v1 = values.max(2, keepdim=True).values
        best_j = torch.where(values >= v1, iota_q, Q).min(2, keepdim=True).values
        best_onehot = iota_q == best_j
        v2 = torch.where(best_onehot, neg, values).max(2, keepdim=True).values
        bid_inc = v1 - v2 + eps[:, None, None]
        bidding = (person_obj < 0) & valid3
        bids = torch.where(bidding & best_onehot, bid_inc, neg)
        win_val = bids.max(1, keepdim=True).values  # [B,1,Q]
        has_bid = win_val > _NEG * 0.5
        win_n = torch.where((bids >= win_val) & has_bid, iota_n, N).min(1, keepdim=True).values
        is_win = (iota_n == win_n) & has_bid
        new_price = torch.where(has_bid, price + win_val, price)
        holds = (iota_q == person_obj) & (person_obj >= 0)
        lost = (holds & has_bid).any(2, keepdim=True)
        po = torch.where(lost, -1, person_obj)
        new_assign = torch.where(is_win, iota_q, -1).max(2, keepdim=True).values
        po = torch.where(new_assign >= 0, new_assign, po).int()
        price = torch.where(active, new_price, price)
        person_obj = torch.where(active, po, person_obj)
    return person_obj[..., 0], rounds


def _jv_plain(cost, valid):
    """Exact Jonker-Volgenant from scratch (pallas_auction.py:39-154), one
    element per row of the batch: cost [E,N,Q] (minimize), valid [E,N] →
    person_obj [E,N] (-1 where unassigned) and the Dijkstra scans each
    element ran [E]."""
    E, N, Q = cost.shape
    dev = cost.device
    f32, i32 = torch.float32, torch.int32
    iota_q = torch.arange(Q, device=dev)
    iota_n = torch.arange(N, device=dev)
    u = torch.zeros(E, N, dtype=f32, device=dev)
    v = torch.zeros(E, Q, dtype=f32, device=dev)
    owner = torch.full((E, Q), -1, dtype=i32, device=dev)
    inf = torch.tensor(_INF, dtype=f32, device=dev)
    scans = torch.zeros(E, dtype=torch.int64, device=dev)
    for i in range(N):
        run = valid[:, i] & (owner < 0).any(1)
        if not bool(run.any()):
            continue
        minv = torch.full((E, Q), _INF, dtype=f32, device=dev)
        used = torch.zeros(E, Q, dtype=i32, device=dev)
        way = torch.full((E, Q), -1, dtype=i32, device=dev)
        j0 = torch.full((E,), -1, dtype=i32, device=dev)
        found = torch.zeros(E, dtype=i32, device=dev)
        it = torch.zeros(E, dtype=i32, device=dev)
        u_, v_ = u, v
        start_row = (iota_n == i).to(f32)
        while True:
            act = run & (found == 0) & (it <= Q)
            if not bool(act.any()):
                break
            used_n = torch.where(iota_q == j0[:, None], 1, used).int()
            i0 = torch.where(j0 < 0, i, _gather0(owner, j0))
            ok = (i0 >= 0) & (i0 < N)
            row = torch.gather(cost, 1, i0.clamp(0, N - 1).long()[:, None, None].expand(E, 1, Q))[:, 0]
            row = torch.where(ok[:, None], row, inf)
            u_i0 = _gather0(u_, i0, 0.0)
            cur = row - u_i0[:, None] - v_
            unused = used_n == 0
            upd = unused & (cur < minv)
            minv_n = torch.where(upd, cur, minv)
            way_n = torch.where(upd, j0[:, None], way)
            dm = torch.where(unused, minv_n, inf)
            delta = dm.min(1).values
            j1 = torch.where(dm <= delta[:, None], iota_q, Q).min(1).values.int()
            used_b = used_n > 0
            owned_used = ((iota_n[None, :, None] == owner[:, None, :])
                          & used_b[:, None, :]).any(2).to(f32)
            u_n = u_ + delta[:, None] * (owned_used + start_row)
            v_n = torch.where(used_b, v_ - delta[:, None], v_)
            minv_n = torch.where(unused, minv_n - delta[:, None], minv_n)
            found_n = torch.where(j1 >= Q, 2, torch.where(_gather0(owner, j1) < 0, 1, 0)).int()
            a = act[:, None]
            minv, used, way = (torch.where(a, minv_n, minv), torch.where(a, used_n, used),
                               torch.where(a, way_n, way))
            u_, v_ = torch.where(a, u_n, u_), torch.where(a, v_n, v_)
            j0, found = torch.where(act, j1, j0), torch.where(act, found_n, found)
            it = it + act.int()
        scans += it
        # augment: walk predecessors from the free column to the start row
        own2, j = owner, j0
        done = torch.zeros(E, dtype=i32, device=dev)
        it = torch.zeros(E, dtype=i32, device=dev)
        while True:
            act = run & (done == 0) & (it <= N + 1)
            if not bool(act.any()):
                break
            pj = _gather0(way, j)
            new_owner = torch.where(pj < 0, i, _gather0(own2, pj))
            own2_n = torch.where(iota_q == j[:, None], new_owner[:, None], own2).int()
            own2 = torch.where(act[:, None], own2_n, own2)
            done = torch.where(act, (pj < 0).int(), done)
            j = torch.where(act, pj, j)
            it = it + act.int()
        r = run[:, None]
        u, v, owner = torch.where(r, u_, u), torch.where(r, v_, v), torch.where(r, own2, owner)
    hit = iota_n[None, :, None] == owner[:, None, :]
    return torch.where(hit, iota_q, -1).max(2).values.int(), scans


def greedy_complete_plain(benefit, valid, person_obj):
    """K1's escalate=False branch (pallas_auction.py:251-275), over the
    batch: rows left unassigned, in row order, take their best free object
    (benefit floored at NEG, first column of the max) if it is above NEG/2."""
    B, N, Q = benefit.shape
    iota_q = torch.arange(Q, device=benefit.device)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=benefit.device)
    taken = ((iota_q == person_obj[..., None]) & (person_obj[..., None] >= 0)).any(1)
    person_obj = person_obj.clone()
    for n in range(N):
        needs = (person_obj[:, n] < 0) & valid[:, n]
        vals = torch.where(taken, neg, torch.maximum(benefit[:, n], neg))
        vmax = vals.max(1).values
        best = torch.where(vals >= vmax[:, None], iota_q, Q).min(1).values
        assign = needs & (vmax > _NEG * 0.5)
        person_obj[:, n] = torch.where(assign, best.int(), person_obj[:, n])
        taken = taken | (assign[:, None] & (iota_q == best[:, None]))
    return person_obj


def _solve_plain(benefit, valid, eps, max_iters, escalate):
    """(person_obj [B,N], auction rounds [B], escalated [B] bool, JV scans
    [B], 0 where no JV ran)."""
    person_obj, rounds = auction_phase_plain(benefit, valid, eps, max_iters)
    unconverged = ((person_obj < 0) & valid).any(1)
    scans = torch.zeros_like(rounds)
    if not escalate:
        person_obj = greedy_complete_plain(benefit, valid, person_obj)
    elif bool(unconverged.any()):
        idx = unconverged.nonzero()[:, 0]
        person_obj = person_obj.clone()
        person_obj[idx], scans[idx] = _jv_plain(-benefit[idx], valid[idx])
    return person_obj, rounds, unconverged, scans


def auction_solve_plain(benefit: torch.Tensor, valid: torch.Tensor, eps: torch.Tensor,
                        *, max_iters: int = 1000, escalate: bool = True) -> torch.Tensor:
    """K1 + K2 in PyTorch ops: benefit [B,N,Q] f32 (maximize, invalid rows
    already 0), valid [B,N] bool, eps [B] f32 → [B,N] int32. escalate=False:
    the greedy completion instead of JV."""
    return _solve_plain(benefit, valid, eps, max_iters, escalate)[0]


def auction_counts_plain(benefit, valid, eps, max_iters):
    """The loop counts the kernel's time follows, from the plain version:
    auction rounds per element [B], the elements escalated [B] bool, and
    the Dijkstra scans of each escalated element's JV [B] (0 elsewhere)."""
    _, rounds, escalated, scans = _solve_plain(benefit, valid, eps, max_iters, True)
    return {"rounds": rounds, "escalated": escalated, "jv_scans": scans}


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _q1(benefit: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Q == 1: the valid row with the largest benefit takes the object."""
    N = benefit.shape[1]
    vals = torch.where(valid, benefit[..., 0], torch.full_like(benefit[..., 0], _NEG))
    best = vals.argmax(1)
    hit = (torch.arange(N, device=benefit.device)[None, :] == best[:, None]) & valid
    return torch.where(hit, 0, -1).int()


def auction_solve(benefit: torch.Tensor, valid: torch.Tensor, eps: torch.Tensor,
                  *, max_iters: int = 1000, escalate: bool = True) -> torch.Tensor:
    """benefit [B,N,Q] f32, valid [B,N] bool, eps [B] f32 → [B,N] int32
    (the object of each row, -1 where unassigned). The kernel on CUDA, the
    plain version on the CPU; the Q == 1 shortcut and the masking of
    invalid rows to 0 as auction_solve_pallas does them. escalate=False
    completes an unconverged element greedily instead of by JV."""
    B, N, Q = benefit.shape
    if Q == 1:
        return _q1(benefit, valid)
    benefit = torch.where(valid[..., None], benefit, torch.zeros_like(benefit)).float()
    eps = eps.reshape(B).float()
    if benefit.device.type == "cpu":
        return auction_solve_plain(benefit, valid, eps, max_iters=max_iters,
                                   escalate=escalate)
    benefit = benefit.contiguous()
    valid_i = valid.to(torch.int32).contiguous()
    eps = eps.contiguous()
    check_cuda("auction_solve", benefit, valid_i, eps)
    lib = build()
    smem = lib.automoe_auction_smem_bytes(N, Q)
    if smem > _MAX_SMEM:
        raise ValueError(f"auction_solve: N={N}, Q={Q} needs {smem} bytes of shared "
                         f"memory, more than a block has ({_MAX_SMEM})")
    out = torch.empty((B, N), dtype=torch.int32, device=benefit.device)
    if B == 0:
        return out
    err = lib.automoe_auction_solve(
        benefit.data_ptr(), valid_i.data_ptr(), eps.data_ptr(), out.data_ptr(),
        B, N, Q, int(max_iters), int(escalate),
        torch.cuda.current_stream(benefit.device).cuda_stream,
    )
    raise_on(err, "auction_solve")
    LAUNCHES["auction_solve"] += 1
    return out


@torch.no_grad()
def auction_match_kernel(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                         tgt_boxes: torch.Tensor, tgt_labels: torch.Tensor, *,
                         cost_class: float = 1.0, cost_bbox: float = 5.0,
                         cost_giou: float = 2.0, max_iters: int = 128):
    """hungarian_match-compatible matcher over `auction_solve` (matcher
    name 'auction_kernel'): the [B,N,Q] benefit, eps = spread·1e-6/N, and
    (query_idx [B,N] int32, valid [B,N] bool) with rows left unassigned
    (only when #valid targets > Q) dropped, never clipped onto query 0."""
    from automoe_tpu_torch.ops.matching import match_cost_matrix

    valid = tgt_labels >= 0
    cost = match_cost_matrix(pred_logits.detach(), pred_boxes.detach(), tgt_boxes,
                             tgt_labels, cost_class=cost_class, cost_bbox=cost_bbox,
                             cost_giou=cost_giou)
    benefit = -cost.transpose(1, 2).float()
    benefit = torch.where(valid[..., None], benefit, torch.zeros_like(benefit))
    N = benefit.shape[1]
    spread = torch.clamp(benefit.amax((1, 2)) - benefit.amin((1, 2)), min=1e-3)
    eps = spread * 1e-6 / max(N, 1)
    qi = auction_solve(benefit, valid, eps, max_iters=max_iters)
    valid = valid & (qi >= 0)
    return torch.clamp(qi, min=0).int(), valid
