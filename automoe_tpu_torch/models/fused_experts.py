"""Fused multi-expert ResNet trunk (port of automoe_tpu/models/fused_experts.py):
N ResNet-18s as ONE grouped-conv network, NCHW.

The experts' trunks share one topology over the same image, so their
convolutions run as one network with `groups=N`: the image is tiled N
times along the channels, every conv is an `nn.Conv2d(groups=N)` and every
BatchNorm runs over N·C channels. A grouped conv over per-expert weights
concatenated along the output channels is exactly N separate convs.

`fuse_backbone_params` / `fuse_expert_variables` build the fused trunk's
state dict from N of the port's backbone / expert state dicts (OIHW
weights and BatchNorm vectors concatenated on dim 0), and
`fuse_automoe_state_dict` an AutoMoE state dict's `FusedAutoMoE`
counterpart, so checkpoints stay per expert and fusion is a serving-time
transform. Module names mirror the JAX package's (`fused_trunk.layer1_0.
conv1.weight`, `expert_{i}_head.*`, `extractor_{i}.*`); the context,
gating and policy modules keep the AutoMoE names.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from automoe_tpu_torch.configs import load_model_config
from automoe_tpu_torch.models.automoe import full_context_data
from automoe_tpu_torch.models.context import make_context_extractor
from automoe_tpu_torch.models.experts import _ConvHead, bilinear_resize
from automoe_tpu_torch.models.extractors import make_extractor
from automoe_tpu_torch.models.gating import gating_network_from_config
from automoe_tpu_torch.models.policy import TrajectoryPolicy
from automoe_tpu_torch.models.resnet import STAGES


def _bn(channels: int, fk) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1, **fk)


class FusedBasicBlock(nn.Module):
    """N BasicBlocks as one: `inplanes` and `filters` per expert."""

    def __init__(self, inplanes: int, filters: int, groups: int, stride: int = 1, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        cin, total = inplanes * groups, filters * groups
        self.conv1 = nn.Conv2d(cin, total, 3, stride, 1, bias=False, groups=groups, **fk)
        self.bn1 = _bn(total, fk)
        self.conv2 = nn.Conv2d(total, total, 3, 1, 1, bias=False, groups=groups, **fk)
        self.bn2 = _bn(total, fk)
        self.downsample_conv = self.downsample_bn = None
        if inplanes != filters or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, total, 1, stride, bias=False,
                                             groups=groups, **fk)
            self.downsample_bn = _bn(total, fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + r)


class FusedResNet18Trunk(nn.Module):
    """N grouped ResNet-18 trunks over one shared image: [B,3,H,W] is tiled
    to [B,3N,H,W]; the output [B,512N,H/32,W/32] holds expert i's feature
    map in channels [512i, 512(i+1))."""

    def __init__(self, groups: int, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.groups = groups
        self.conv1 = nn.Conv2d(3 * groups, 64 * groups, 7, 2, 3, bias=False, groups=groups,
                               **fk)
        self.bn1 = _bn(64 * groups, fk)
        inplanes = 64
        for stage, (filters, stride) in enumerate(STAGES, start=1):
            setattr(self, f"layer{stage}_0",
                    FusedBasicBlock(inplanes, filters, groups, stride, **fk))
            setattr(self, f"layer{stage}_1", FusedBasicBlock(filters, filters, groups, 1, **fk))
            inplanes = filters

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(image.repeat(1, self.groups, 1, 1))))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, len(STAGES) + 1):
            x = getattr(self, f"layer{stage}_1")(getattr(self, f"layer{stage}_0")(x))
        return x


def split_fused_features(feats: torch.Tensor, groups: int) -> List[torch.Tensor]:
    """[B,512N,h,w] → N x [B,512,h,w] per-expert feature maps."""
    per = feats.shape[1] // groups
    return [feats[:, i * per:(i + 1) * per] for i in range(groups)]


# ---------------------------------------------------------------------------
# Weight fusion: N ResNet18Backbone state dicts → one fused trunk's
# ---------------------------------------------------------------------------

def _fused_name(key: str) -> str:
    """A ResNet18Backbone state-dict key → its FusedResNet18Trunk key:
    `0.weight` → `conv1.weight`, `1.*` → `bn1.*`, `4.0.conv1.weight` →
    `layer1_0.conv1.weight`, `5.0.downsample.1.*` → `layer2_0.downsample_bn.*`."""
    head, _, rest = key.partition(".")
    if head in ("0", "1"):
        return f"{'conv1' if head == '0' else 'bn1'}.{rest}"
    blk, _, rest = rest.partition(".")
    rest = re.sub(r"^downsample\.0\.", "downsample_conv.", rest)
    rest = re.sub(r"^downsample\.1\.", "downsample_bn.", rest)
    return f"layer{int(head) - 3}_{blk}.{rest}"


def fuse_backbone_params(backbones: Sequence[Dict[str, torch.Tensor]]
                         ) -> Dict[str, torch.Tensor]:
    """N ResNet18Backbone state dicts → the FusedResNet18Trunk state dict.
    Grouped conv weights (OIHW) are the per-expert weights concatenated
    along the output channels (group g reads input channels [g*in,
    (g+1)*in)); BatchNorm vectors are concatenated. A step count
    (`num_batches_tracked`, which a BatchNorm with a momentum never reads)
    is the first trunk's."""
    out = {}
    for key in backbones[0]:
        leaves = [b[key] for b in backbones]
        out[_fused_name(key)] = (leaves[0] if key.endswith("num_batches_tracked")
                                 else torch.cat(leaves, dim=0))
    return out


def _backbone_of(sd: Dict[str, torch.Tensor], prefix: str = "") -> Dict[str, torch.Tensor]:
    """The trunk of an expert's state dict (its `backbone.` or, for
    nuScenes, `image_backbone.` entries) under `prefix`."""
    for name in ("backbone.", "image_backbone."):
        sub = {k[len(prefix + name):]: v for k, v in sd.items() if k.startswith(prefix + name)}
        if sub:
            return sub
    raise KeyError(f"no backbone under {prefix!r}")


def fuse_expert_variables(expert_state_dicts: Sequence[Dict[str, torch.Tensor]]
                          ) -> Dict[str, torch.Tensor]:
    """N experts' state dicts (each with its `backbone.*` or
    `image_backbone.*` trunk) → the fused trunk's state dict."""
    return fuse_backbone_params([_backbone_of(sd) for sd in expert_state_dicts])


# ---------------------------------------------------------------------------
# Fused AutoMoE: the serving-time composite with one trunk for all experts
# ---------------------------------------------------------------------------

class FusedAutoMoE(nn.Module):
    """AutoMoE whose experts' ResNet-18 trunks run as one grouped network:
    equal to AutoMoE (without fast_gating_pool: segmentation and drivable
    logits are upsampled to the image) on the weights that
    `fuse_automoe_state_dict` fuses. Training runs on AutoMoE; this model
    serves. Image-only: a LiDAR nuScenes expert raises. Inference: build it
    in eval mode (`create_fused_automoe_model`)."""

    def __init__(self, config, *, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.config = config = load_model_config(config)
        groups = len(config.experts)
        for e in config.experts:
            if e.type == "nuscenes" and e.use_lidar:
                raise NotImplementedError("fused path is image-only nuScenes")
        self.context_extractor = make_context_extractor(config.context, **fk)
        self.fused_trunk = FusedResNet18Trunk(groups, **fk)
        for i, e in enumerate(config.experts):
            if e.type == "detection":
                setattr(self, f"expert_{i}_head", _ConvHead(e.num_classes + 4, **fk))
            elif e.type in ("segmentation", "drivable"):
                setattr(self, f"expert_{i}_decoder", _ConvHead(e.num_classes, **fk))
            elif e.type == "nuscenes":
                setattr(self, f"expert_{i}_image_projection", nn.Linear(512, 256, **fk))
                setattr(self, f"expert_{i}_query_embed",
                        nn.Parameter(torch.randn(e.num_queries, 256, **fk)))
                setattr(self, f"expert_{i}_decoder_fc1", nn.Linear(256, 256, **fk))
                setattr(self, f"expert_{i}_decoder_fc2", nn.Linear(256, 128, **fk))
                setattr(self, f"expert_{i}_class_head", nn.Linear(128, e.num_classes, **fk))
                setattr(self, f"expert_{i}_bbox_head", nn.Linear(128, e.bbox_dim, **fk))
            else:
                raise ValueError(f"unfusable expert type {e.type}")
            setattr(self, f"extractor_{i}", make_extractor(e, **fk))
        self.gating_network = gating_network_from_config(config, **fk)
        self.policy_head = TrajectoryPolicy(
            horizon=config.policy.num_waypoints,
            context_dim=config.gating.processed_dim,
            backbone_dim=config.policy.backbone_dim,
            **fk,
        )

    def _expert_output(self, i: int, ecfg, f: torch.Tensor, image_hw) -> Any:
        m = lambda name: getattr(self, f"expert_{i}_{name}")  # noqa: E731
        if ecfg.type == "detection":
            out = m("head")(f)
            return {"class_logits": out[:, :ecfg.num_classes],
                    "bbox_deltas": out[:, ecfg.num_classes:]}
        if ecfg.type in ("segmentation", "drivable"):
            return bilinear_resize(m("decoder")(f), *image_hw)
        proj = m("image_projection")(f.mean(dim=(2, 3)))  # the trunk's GAP
        x = proj[:, None, :] + m("query_embed").to(proj.dtype)[None]
        x = torch.relu(m("decoder_fc2")(torch.relu(m("decoder_fc1")(x))))
        return {"class_logits": m("class_head")(x), "bbox_preds": m("bbox_head")(x)}

    def forward(self, batch: Dict[str, torch.Tensor], *,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """batch["image"] NHWC [B,H,W,3]; the outputs of AutoMoE.forward.
        The context reads speed and each control on its own where present
        (zeros otherwise), as the JAX package's FusedAutoMoE does."""
        image = batch["image"].permute(0, 3, 1, 2)
        B, dtype = image.shape[0], image.dtype
        data = full_context_data(batch, B, dtype, image.device)
        if self.config.context.type == "simple":
            context_features = self.context_extractor(
                *(data[k] for k in ("speed", "steering", "throttle", "brake")))
        else:
            context_features = self.context_extractor(data)
        parts = split_fused_features(self.fused_trunk(image), len(self.config.experts))
        expert_outputs = [self._expert_output(i, e, f, image.shape[2:])
                          for i, (e, f) in enumerate(zip(self.config.experts, parts))]
        features = [getattr(self, f"extractor_{i}")(out) for i, out in enumerate(expert_outputs)]
        gating_output = self.gating_network(features, context_features, generator=generator)
        policy = self.policy_head(image, gating_output["combined_output"])
        speed_seq = policy["speed"]
        return {
            "waypoints": policy["waypoints"],
            "speed": speed_seq[:, -1:],
            "speed_seq": speed_seq,
            "expert_weights": gating_output["expert_weights"],
            "expert_outputs": expert_outputs,
            "context_features": context_features,
            "combined_features": gating_output["combined_output"],
            "gate_logits": gating_output["gate_logits"],
        }


def create_fused_automoe_model(config, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                               *, device=None, dtype=torch.float32) -> FusedAutoMoE:
    """FusedAutoMoE in eval mode on `device` (default cuda; raises where
    no GPU is present unless device="cpu"), loaded from a
    `fuse_automoe_state_dict` result when one is given."""
    from automoe_tpu_torch.utils import resolve_device

    model = FusedAutoMoE(config, device=resolve_device(device), dtype=dtype)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()


#: a nuScenes expert's modules: (AutoMoE name, FusedAutoMoE name)
_NUSCENES_PARTS = (("image_projection", "image_projection"),
                   ("query_embed.weight", "query_embed"),
                   ("decoder.0", "decoder_fc1"), ("decoder.3", "decoder_fc2"),
                   ("class_head", "class_head"), ("bbox_head", "bbox_head"))


def fuse_automoe_state_dict(state_dict: Dict[str, torch.Tensor], config
                            ) -> Dict[str, torch.Tensor]:
    """An AutoMoE state dict (the port's names) → the FusedAutoMoE state dict
    (the counterpart of the JAX package's fuse_automoe_variables)."""
    config = load_model_config(config)
    out = {f"fused_trunk.{k}": v for k, v in fuse_backbone_params(
        [_backbone_of(state_dict, f"experts.{i}.") for i in range(len(config.experts))]
    ).items()}

    def move(src: str, dst: str) -> None:
        for k, v in state_dict.items():
            if k == src or k.startswith(src + "."):
                out[dst + k[len(src):]] = v

    for i, e in enumerate(config.experts):
        parts = {"detection": (("head", "head"),),
                 "segmentation": (("decoder", "decoder"),),
                 "drivable": (("decoder", "decoder"),)}.get(e.type, _NUSCENES_PARTS)
        for src, dst in parts:
            move(f"experts.{i}.{src}", f"expert_{i}_{dst}")
        move(f"expert_extractors.extractors.{i}", f"extractor_{i}")
    for name in ("context_extractor", "gating_network", "policy_head"):
        move(name, name)
    return out
