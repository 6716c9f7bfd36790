"""Cross-component checkpoint composition (port of
automoe_tpu/ckpt/compose.py).

`load_expert_checkpoints` grafts trained expert weights into the full
AutoMoE, as the reference's models/automoe.py:240-267 does. A source is a
torch file: a checkpoint the port's expert trainers wrote
(`<ckpt_root>/bdd_detection/<run>/best.pt`) or a reference `.pth`; both
are read through `load_torch_state_dict`, which unwraps
`model_state_dict` and DDP `module.` prefixes. nuScenes sources get the
reference's load-time key remap (mlp.* → decoder.*, box_head.* →
bbox_head.*). Every key of the expert must be in the file, or the graft
raises (the JAX package only warns). An empty entry skips that expert.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from automoe_tpu_torch.ckpt.checkpoint import load_state_into
from automoe_tpu_torch.ckpt.from_jax import load_torch_state_dict

_NUSCENES_RENAME = (("mlp.", "decoder."), ("box_head.", "bbox_head."))


def _remap_nuscenes_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for old, new in _NUSCENES_RENAME:
            if k.startswith(old):
                k = new + k[len(old):]
                break
        out[k] = v
    return out


@torch.no_grad()
def load_expert_checkpoints(model: nn.Module, config,
                            checkpoint_paths: Sequence[str]) -> nn.Module:
    """Load each non-empty path into `model.experts[i]` (weights and
    BatchNorm statistics), in place; returns the model."""
    if len(checkpoint_paths) != len(config.experts):
        raise ValueError(f"expected {len(config.experts)} checkpoint paths, got "
                         f"{len(checkpoint_paths)}")
    for ecfg, expert, path in zip(config.experts, model.experts, checkpoint_paths):
        if not path:
            continue
        sd = load_torch_state_dict(path)
        if ecfg.type == "nuscenes":
            sd = _remap_nuscenes_keys(sd)
        load_state_into(expert, sd, path)
    return model
