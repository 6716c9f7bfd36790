"""Trajectory (policy) and gating losses (port of
automoe_tpu/losses/trajectory.py).

Policy loss (the reference's train_carla_policy.py:22-31):
  ADE + 2·FDE + 0.2·speed L1 + 0.1·smoothness (L1 of consecutive
  waypoint-delta differences).

Gating loss (train_gating_network.py:21-79): the trajectory terms with
configurable weights plus
  * load balancing: MSE(mean expert usage, uniform), weight 0.01;
  * negative entropy of the expert weights (confidence bonus), weight 0.001.
`loss_config` keys and defaults are the JAX package's: use_load_balancing,
use_entropy_loss (True), ade_weight 1.0, fde_weight 2.0, speed_weight 0.2,
smoothness_weight 0.1, load_balancing_weight 0.01, entropy_weight 0.001.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def _trajectory_terms(pred_wp: torch.Tensor, target_wp: torch.Tensor) -> Dict[str, torch.Tensor]:
    deltas = pred_wp[:, 1:, :] - pred_wp[:, :-1, :]
    return {
        "ade": _l1(pred_wp, target_wp),
        "fde": _l1(pred_wp[:, -1, :], target_wp[:, -1, :]),
        "smoothness": _l1(deltas[:, 1:, :], deltas[:, :-1, :]),
    }


def _speed_term(pred: Mapping[str, torch.Tensor], target_spd: torch.Tensor) -> torch.Tensor:
    """Full-profile L1 when the horizons line up, else last-step L1
    (train_gating_network.py:28-37)."""
    pred_spd = pred.get("speed_seq", pred.get("speed"))
    if (pred_spd is not None and pred_spd.ndim == 2 and target_spd.ndim == 2
            and pred_spd.shape[1] == target_spd.shape[1]):
        return _l1(pred_spd, target_spd)
    pred_last = pred.get("speed")
    if pred_last is not None and pred_last.ndim == 2 and pred_last.shape[1] == 1:
        return _l1(pred_last, target_spd[:, -1:])
    return target_spd.new_zeros((), dtype=torch.float32)


def policy_losses(pred: Mapping[str, torch.Tensor], target_wp: torch.Tensor,
                  target_spd: torch.Tensor) -> Dict[str, torch.Tensor]:
    t = _trajectory_terms(pred["waypoints"], target_wp)
    speed = _l1(pred["speed"], target_spd)
    loss = t["ade"] + 2.0 * t["fde"] + 0.2 * speed + 0.1 * t["smoothness"]
    return {"loss": loss, "ade": t["ade"], "fde": t["fde"], "speed": speed,
            "smooth": t["smoothness"]}


def gating_losses(pred: Mapping[str, torch.Tensor], target_wp: torch.Tensor,
                  target_spd: torch.Tensor,
                  config: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    cfg = dict(config or {})
    t = _trajectory_terms(pred["waypoints"], target_wp)
    speed_loss = _speed_term(pred, target_spd)
    w = pred["expert_weights"].float()  # [B, E]
    zero = w.new_zeros(())
    if cfg.get("use_load_balancing", True):
        mean_usage = w.mean(dim=0)
        load_balancing = ((mean_usage - 1.0 / mean_usage.shape[0]) ** 2).mean()
    else:
        load_balancing = zero
    if cfg.get("use_entropy_loss", True):
        entropy = -(w * torch.log(w + 1e-8)).sum(dim=1).mean()
        entropy_loss = -entropy  # negative entropy → confident selection
    else:
        entropy_loss = zero
    total = (cfg.get("ade_weight", 1.0) * t["ade"]
             + cfg.get("fde_weight", 2.0) * t["fde"]
             + cfg.get("speed_weight", 0.2) * speed_loss
             + cfg.get("smoothness_weight", 0.1) * t["smoothness"]
             + cfg.get("load_balancing_weight", 0.01) * load_balancing
             + cfg.get("entropy_weight", 0.001) * entropy_loss)
    return {"total_loss": total, "ade": t["ade"], "fde": t["fde"], "speed": speed_loss,
            "smoothness": t["smoothness"], "load_balancing": load_balancing,
            "entropy": entropy_loss}
