"""Weights into the port: JAX-package variables and reference `.pth` files.

`state_dict_from_jax` maps the JAX package's `{"params", "batch_stats"}`
trees (as numpy arrays) onto the port's state dict, which uses the
reference torch names and layouts (conv HWIO→OIHW, linear
[in,out]→[out,in], BatchNorm running stats). It keeps its own copy of the
naming the JAX package's `ckpt/torch_export.py` encodes, so the port
imports nothing of that package.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from automoe_tpu_torch.configs import load_model_config
from automoe_tpu_torch.models.deep_policy import PIPELINE_BLOCKS


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a contiguous, writable copy


class _Sink:
    def __init__(self):
        self.out: Dict[str, torch.Tensor] = {}

    def conv(self, name: str, tree: Dict[str, Any]):
        self.out[f"{name}.weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in tree:
            self.out[f"{name}.bias"] = _t(tree["bias"])

    def conv1d(self, name: str, tree: Dict[str, Any]):
        """A per-point Dense kernel [in,out] → Conv1d weight [out,in,1]."""
        self.out[f"{name}.weight"] = _t(np.asarray(tree["kernel"]).T[:, :, None])
        self.out[f"{name}.bias"] = _t(tree["bias"])

    def linear(self, name: str, tree: Dict[str, Any]):
        self.out[f"{name}.weight"] = _t(np.asarray(tree["kernel"]).T)
        if "bias" in tree:
            self.out[f"{name}.bias"] = _t(tree["bias"])

    def norm(self, name: str, params: Dict, stats: Dict | None = None):
        self.out[f"{name}.weight"] = _t(params["scale"])
        self.out[f"{name}.bias"] = _t(params["bias"])
        if stats:
            self.out[f"{name}.running_mean"] = _t(stats["mean"])
            self.out[f"{name}.running_var"] = _t(stats["var"])
            self.out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _resnet(sink: _Sink, prefix: str, p: Dict, s: Dict):
    """ResNet18Backbone tree → `{prefix}0..7` (Sequential children)."""
    sink.conv(f"{prefix}0", p["conv1"])
    sink.norm(f"{prefix}1", p["bn1"], s.get("bn1"))
    for idx, stage in ((4, 1), (5, 2), (6, 3), (7, 4)):
        for blk in (0, 1):
            bp = p[f"layer{stage}_{blk}"]
            bs = s.get(f"layer{stage}_{blk}", {})
            base = f"{prefix}{idx}.{blk}"
            sink.conv(f"{base}.conv1", bp["conv1"])
            sink.norm(f"{base}.bn1", bp["bn1"], bs.get("bn1"))
            sink.conv(f"{base}.conv2", bp["conv2"])
            sink.norm(f"{base}.bn2", bp["bn2"], bs.get("bn2"))
            if "downsample_conv" in bp:
                sink.conv(f"{base}.downsample.0", bp["downsample_conv"])
                sink.norm(f"{base}.downsample.1", bp["downsample_bn"],
                          bs.get("downsample_bn"))


def _point_mlp(sink: _Sink, prefix: str, p: Dict, s: Dict):
    """The layers a TNet and a PointNet share: conv1..3, fc1..3, bn1..5."""
    for j in (1, 2, 3):
        sink.conv1d(f"{prefix}conv{j}", p[f"conv{j}"])
        sink.linear(f"{prefix}fc{j}", p[f"fc{j}"])
    for j in range(1, 6):
        sink.norm(f"{prefix}bn{j}", p[f"bn{j}"], s.get(f"bn{j}"))


def _pointnet(sink: _Sink, prefix: str, p: Dict, s: Dict):
    _point_mlp(sink, prefix, p, s)
    for t in ("input_transform", "feature_transform"):
        if t in p:
            _point_mlp(sink, f"{prefix}{t}.", p[t], s.get(t, {}))


def _expert(sink: _Sink, expert_type: str, prefix: str, p: Dict, s: Dict):
    if expert_type in ("detection", "segmentation", "drivable"):
        _resnet(sink, f"{prefix}backbone.", p["backbone"], s.get("backbone", {}))
        head = "head" if expert_type == "detection" else "decoder"
        sink.conv(f"{prefix}{head}.0", p[head]["conv1"])
        sink.conv(f"{prefix}{head}.2", p[head]["conv2"])
    elif expert_type == "nuscenes":
        _resnet(sink, f"{prefix}image_backbone.", p["image_backbone"],
                s.get("image_backbone", {}))
        sink.linear(f"{prefix}image_projection", p["image_projection"])
        if "lidar_backbone" in p:
            _pointnet(sink, f"{prefix}lidar_backbone.", p["lidar_backbone"],
                      s.get("lidar_backbone", {}))
        sink.out[f"{prefix}query_embed.weight"] = _t(p["query_embed"])
        sink.linear(f"{prefix}decoder.0", p["decoder_fc1"])
        sink.linear(f"{prefix}decoder.3", p["decoder_fc2"])
        sink.linear(f"{prefix}class_head", p["class_head"])
        sink.linear(f"{prefix}bbox_head", p["bbox_head"])
    elif expert_type == "nuscenes_2d":  # NuScenesImage2DHead
        _resnet(sink, f"{prefix}image_backbone.", p["image_backbone"],
                s.get("image_backbone", {}))
        sink.linear(f"{prefix}image_projection", p["image_projection"])
        sink.out[f"{prefix}query_embed.weight"] = _t(p["query_embed"])
        sink.linear(f"{prefix}mlp.0", p["mlp_fc1"])
        sink.linear(f"{prefix}mlp.3", p["mlp_fc2"])
        sink.linear(f"{prefix}class_head", p["class_head"])
        sink.linear(f"{prefix}box_head", p["box_head"])
    else:
        raise ValueError(expert_type)


def expert_state_dict_from_jax(variables_np: Dict[str, Any],
                               expert_type: str) -> Dict[str, torch.Tensor]:
    """A standalone JAX expert's `{"params", "batch_stats"}` (numpy leaves,
    e.g. a trained BDDDetectionExpert) → the port's expert state dict
    (`backbone.*`, `head.*` / `decoder.*`, …). expert_type is a config
    type, or "nuscenes_2d" for a NuScenesImage2DHead."""
    sink = _Sink()
    _expert(sink, expert_type, "", variables_np["params"],
            variables_np.get("batch_stats", {}))
    return sink.out


def state_dict_from_jax(variables_np: Dict[str, Any], config) -> Dict[str, torch.Tensor]:
    """JAX AutoMoE variables (numpy leaves) → the port's state dict."""
    cfg = load_model_config(config)
    sink = _Sink()
    params = variables_np["params"]
    stats = variables_np.get("batch_stats", {})

    for i, ecfg in enumerate(cfg.experts):
        _expert(sink, ecfg.type, f"experts.{i}.", params[f"expert_{i}"],
                stats.get(f"expert_{i}", {}))
        head = params[f"extractor_{i}"]["head"]
        a, b, c = (0, 3, 4) if ecfg.type == "nuscenes" else (2, 5, 6)
        base = f"expert_extractors.extractors.{i}.feature_extractor."
        sink.linear(f"{base}{a}", head["fc1"])
        sink.linear(f"{base}{b}", head["fc2"])
        sink.norm(f"{base}{c}", head["ln"])

    cp = params["context_extractor"]
    seq = "encoder" if cfg.context.type == "simple" else "context_encoder"
    sink.linear(f"context_extractor.{seq}.0", cp["fc1"])
    sink.linear(f"context_extractor.{seq}.3", cp["fc2"])
    sink.norm(f"context_extractor.{seq}.4", cp["ln"])

    _gating(sink, "gating_network.", params["gating_network"], len(cfg.experts))
    _policy(sink, "policy_head.", params["policy_head"], stats.get("policy_head", {}))
    return sink.out


def _gating(sink: _Sink, prefix: str, gp: Dict, num_experts: int):
    sink.linear(f"{prefix}context_encoder.context_encoder.0", gp["context_encoder"]["fc1"])
    sink.linear(f"{prefix}context_encoder.context_encoder.3", gp["context_encoder"]["fc2"])
    for i in range(num_experts):
        pp = gp[f"expert_processor_{i}"]
        base = f"{prefix}expert_processors.{i}.processor"
        sink.linear(f"{base}.0", pp["fc1"])
        sink.linear(f"{base}.3", pp["fc2"])
        sink.norm(f"{base}.4", pp["ln"])
    sink.linear(f"{prefix}gate_network.0", gp["gate_fc1"])
    sink.linear(f"{prefix}gate_network.3", gp["gate_fc2"])
    sink.linear(f"{prefix}output_projection", gp["output_projection"])


def gating_state_dict_from_jax(params: Dict[str, Any], num_experts: int
                               ) -> Dict[str, torch.Tensor]:
    """A standalone JAX GatingNetwork's params (numpy leaves) → the port's
    GatingNetwork state dict."""
    sink = _Sink()
    _gating(sink, "", params, num_experts)
    return sink.out


def _policy(sink: _Sink, prefix: str, p: Dict, s: Dict):
    bs = s.get("backbone", {})
    for j in range(4):
        sink.conv(f"{prefix}backbone.net.{3 * j}", p["backbone"][f"conv{j}"])
        sink.norm(f"{prefix}backbone.net.{3 * j + 1}", p["backbone"][f"bn{j}"], bs.get(f"bn{j}"))
    sink.linear(f"{prefix}backbone.fc", p["backbone"]["fc"])
    for head in ("head_wp", "head_spd"):
        for j, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
            sink.linear(f"{prefix}{head}.{j}", p[head][fc])


def policy_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A standalone JAX TrajectoryPolicy's `{"params", "batch_stats"}`
    (numpy leaves) → the port's TrajectoryPolicy state dict."""
    sink = _Sink()
    _policy(sink, "", variables_np["params"], variables_np.get("batch_stats", {}))
    return sink.out


def deep_policy_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX DeepTrajectoryPolicy's `{"params"}` (numpy leaves) → the
    port's DeepTrajectoryPolicy state dict: the stem conv HWIO → OIHW,
    its GroupNorm affine [1,1,C] → [C], the stacked trunk's convs
    [L,3,3,C,C] → [L,C,C,3,3] and its GroupNorm leaves [L,1,1,1,C] →
    [L,C], then `fc` and the heads."""
    p = variables_np["params"]
    sink = _Sink()
    sink.conv("stem_conv", p["stem_conv"])
    sink.out["stem_gn.weight"] = _t(np.asarray(p["stem_gn_scale"]).reshape(-1))
    sink.out["stem_gn.bias"] = _t(np.asarray(p["stem_gn_bias"]).reshape(-1))
    blocks = p[PIPELINE_BLOCKS]
    for k in ("conv1", "conv2"):
        sink.out[f"{PIPELINE_BLOCKS}.{k}"] = _t(np.asarray(blocks[k]).transpose(0, 4, 3, 1, 2))
    for k in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias"):
        leaf = np.asarray(blocks[k])
        sink.out[f"{PIPELINE_BLOCKS}.{k}"] = _t(leaf.reshape(leaf.shape[0], -1))
    sink.linear("fc", p["fc"])
    for head in ("head_wp", "head_spd"):
        for j, fc in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
            sink.linear(f"{head}.{j}", p[head][fc])
    return sink.out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference `.pth` checkpoint to a state dict, unwrapping
    `{'model_state_dict': ...}` payloads and DDP `module.` prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}
