"""Gating / full-AutoMoE evaluation and the context↔gating correlation
(port of automoe_tpu/evals/gating.py; metrics of the reference's
eval/evaluate_gating_network.py):

* automoe_eval_batch / evaluate_automoe: ADE and FDE in L1 and Euclidean
  norms, speed L1 (full profile when the horizons line up, else last
  step), gating entropy, expert usage mean and std, aggregated weighted by
  each batch's real sample count;
* context_gating_correlation: Pearson and Spearman between the last-step
  vehicle-state context and the gating, as raw logits or as CLR-
  transformed weights (log w − mean log w), near-constant columns dropped.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from automoe_tpu_torch.evals.common import Forward, as_forward

_SCALARS = ("ade_l1", "fde_l1", "ade_euclid", "fde_euclid", "speed_loss", "entropy")


def automoe_eval_batch(pred: Dict[str, torch.Tensor], target_wp: torch.Tensor,
                       target_spd: torch.Tensor) -> Dict[str, torch.Tensor]:
    wp, twp = pred["waypoints"].float(), target_wp.float()
    pred_spd = pred.get("speed_seq", pred.get("speed"))
    if pred_spd is not None and pred_spd.shape[1] == target_spd.shape[1]:
        speed_loss = (pred_spd - target_spd).abs().mean()
    else:
        speed_loss = (pred["speed"] - target_spd[:, -1:]).abs().mean()
    w = pred["expert_weights"].float().clamp(min=1e-8)
    return {
        "ade_l1": (wp - twp).abs().mean(),
        "fde_l1": (wp[:, -1] - twp[:, -1]).abs().mean(),
        "ade_euclid": torch.linalg.vector_norm(wp - twp, dim=-1).mean(),
        "fde_euclid": torch.linalg.vector_norm(wp[:, -1] - twp[:, -1], dim=-1).mean(),
        "speed_loss": speed_loss,
        "entropy": -(w * torch.log(w)).sum(dim=1).mean(),
        "expert_weights": pred["expert_weights"],
        "gate_logits": pred.get("gate_logits", pred["expert_weights"]),
    }


@torch.no_grad()
def evaluate_automoe(model: Forward, batches: Iterable, device=None) -> Dict[str, object]:
    """`model` maps a batch dict of tensors to the AutoMoE output dict: the
    model in eval mode on its device, or a callable (the int8 forward,
    serving/quant.py::make_quant_forward) with `device`. Over numpy
    batches (CARLA sequence loader output); a repeat-padded tail batch
    counts its real rows only."""
    forward, device = as_forward(model, device)
    sums = {k: 0.0 for k in _SCALARS}
    total, weights, logits, ctx_rows = 0, [], [], []
    for batch in batches:
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
              if k != "_real_count" and not isinstance(v, list)}
        m = automoe_eval_batch(forward(tb), tb["waypoints"], tb["speed"])
        bsz = int(batch.get("_real_count", tb["waypoints"].shape[0]))
        for k in sums:
            sums[k] += float(m[k]) * bsz
        weights.append(m["expert_weights"].float().cpu().numpy()[:bsz])
        logits.append(m["gate_logits"].float().cpu().numpy()[:bsz])
        feats = [np.asarray(batch[k])[:bsz, -1:]
                 for k in ("speed", "steering", "throttle", "brake") if k in batch]
        if feats:
            ctx_rows.append(np.concatenate(feats, axis=1))
        total += bsz
    total = max(1, total)
    w = np.concatenate(weights, axis=0) if weights else np.zeros((0, 1))
    out: Dict[str, object] = {k: v / total for k, v in sums.items()}
    out["expert_usage"] = w.mean(axis=0).tolist() if len(w) else []
    out["expert_std"] = w.std(axis=0).tolist() if len(w) else []
    out["expert_weights"] = w
    out["gate_logits"] = np.concatenate(logits, axis=0) if logits else np.zeros((0, 1))
    out["context_rows"] = np.concatenate(ctx_rows, axis=0) if ctx_rows else np.zeros((0, 0))
    return out


def _clr(weights: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    logw = np.log(np.clip(weights, eps, 1.0))
    return logw - logw.mean(axis=1, keepdims=True)


def context_gating_correlation(context: np.ndarray, gating: np.ndarray, *,
                               use_logits: bool = False,
                               context_names: Optional[List[str]] = None,
                               expert_names: Optional[List[str]] = None) -> Dict[str, object]:
    """Pearson/Spearman matrices between context features [N,C] and gating
    [N,E] (logits as they are, weights CLR-transformed)."""
    from scipy.stats import pearsonr, spearmanr

    G = gating.astype(np.float64) if use_logits else _clr(gating)
    C = context.astype(np.float64)
    c_names = list(context_names or []) + [f"ctx_{i}" for i in range(C.shape[1])]
    e_names = list(expert_names or []) + [f"E{j}" for j in range(G.shape[1])]
    c_names, e_names = c_names[: C.shape[1]], e_names[: G.shape[1]]
    c_keep = np.where(C.std(axis=0) > 1e-6)[0]
    g_keep = np.where(G.std(axis=0) > 1e-6)[0]
    C, G = C[:, c_keep], G[:, g_keep]
    pear = np.zeros((C.shape[1], G.shape[1]), np.float32)
    spear = np.zeros_like(pear)
    for i in range(C.shape[1]):
        for j in range(G.shape[1]):
            p = pearsonr(C[:, i], G[:, j])[0]
            s = spearmanr(C[:, i], G[:, j])[0]
            pear[i, j] = 0.0 if np.isnan(p) else p
            spear[i, j] = 0.0 if np.isnan(s) else s
    return {"pearson": pear, "spearman": spear,
            "context_names": [c_names[i] for i in c_keep],
            "expert_names": [e_names[j] for j in g_keep]}
