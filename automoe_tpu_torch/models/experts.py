"""The perception experts (port of automoe_tpu/models/experts.py), NCHW.

Dense-map outputs are [B,C,h,w]; the nuScenes expert's query outputs are
[B,Q,C] as in the JAX package. Each expert splits into its trunk and a
`heads` method over the trunk features, so the int8 serving path
(serving/quant.py) runs the very same head modules over its int8 trunk.

The nuScenes expert is the image-only branch: PointNet/TNet (use_lidar)
are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from automoe_tpu_torch.models.resnet import ResNet18Backbone
from automoe_tpu_torch.ops.resize import resize_bilinear


class _ConvHead(nn.Sequential):
    """3x3 conv(512→256) + ReLU + 1x1 conv(256→out): the shared dense head.
    Children 0 and 2 carry the reference names (`head.0`, `head.2`)."""

    def __init__(self, out_channels: int, *, device=None, dtype=None):
        fk = dict(device=device, dtype=dtype)
        super().__init__(
            nn.Conv2d(512, 256, 3, 1, 1, **fk),
            nn.ReLU(),
            nn.Conv2d(256, out_channels, 1, **fk),
        )


def bilinear_resize(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B,C,h,w] → [B,C,H,W] bilinear (align_corners=False semantics) as
    two matmuls, like the JAX package's experts."""
    y = resize_bilinear(x.permute(0, 2, 3, 1), height, width, antialias=False)
    return y.permute(0, 3, 1, 2)


class BDDDetectionExpert(nn.Module):
    """Dense per-cell detector: ResNet18 trunk → {class_logits, bbox_deltas}."""

    def __init__(self, num_classes: int = 10, *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet18Backbone(device=device, dtype=dtype)
        self.head = _ConvHead(num_classes + 4, device=device, dtype=dtype)

    def heads(self, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.head(feats)
        return {
            "class_logits": out[:, : self.num_classes],  # [B,C,h,w]
            "bbox_deltas": out[:, self.num_classes:],  # [B,4,h,w]
        }

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.heads(self.backbone(x))


class BDDSegmentationExpert(nn.Module):
    """ResNet18 trunk → conv decoder → bilinear upsample to input res.

    upsample=False returns the low-res logits (serving fast path: the
    gating extractor pools them with exact mean-of-resize weights)."""

    def __init__(self, num_classes: int = 19, *, upsample: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.upsample = upsample
        self.backbone = ResNet18Backbone(device=device, dtype=dtype)
        self.decoder = _ConvHead(num_classes, device=device, dtype=dtype)

    def heads(self, feats: torch.Tensor) -> torch.Tensor:
        return self.decoder(feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.heads(self.backbone(x))
        if not self.upsample:
            return logits  # [B,C,H/32,W/32]
        return bilinear_resize(logits, x.shape[2], x.shape[3])


class BDDDrivableExpert(BDDSegmentationExpert):
    """Same architecture, 3 classes {bg, drivable, alternative}."""

    def __init__(self, num_classes: int = 3, *, upsample: bool = True,
                 device=None, dtype=None):
        super().__init__(num_classes, upsample=upsample, device=device,
                         dtype=dtype)


class NuScenesExpert(nn.Module):
    """Camera DETR-lite: global scene feature broadcast over learned
    queries → MLP decoder → class/bbox heads (image-only branch)."""

    def __init__(self, num_queries: int = 100, fusion: str = "concat",
                 use_lidar: bool = False, use_tnet: bool = False,
                 bbox_dim: int = 7, num_classes: int = 10, *,
                 device=None, dtype=None):
        super().__init__()
        if use_lidar:
            raise NotImplementedError(
                "the lidar branch (PointNet/TNet) is not ported yet"
            )
        fk = dict(device=device, dtype=dtype)
        self.image_backbone = ResNet18Backbone(include_pool=True, **fk)
        self.image_projection = nn.Linear(512, 256, **fk)
        self.query_embed = nn.Embedding(num_queries, 256, **fk)
        self.decoder = nn.Sequential(
            nn.Linear(256, 256, **fk), nn.ReLU(), nn.Dropout(0.3),
            nn.Linear(256, 128, **fk), nn.ReLU(), nn.Dropout(0.3),
        )
        self.class_head = nn.Linear(128, num_classes, **fk)
        self.bbox_head = nn.Linear(128, bbox_dim, **fk)

    def heads(self, img_feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B,512] pooled image feature → {class_logits, bbox_preds}."""
        fused = self.image_projection(img_feat)  # image-only
        x = fused[:, None, :] + self.query_embed.weight[None, :, :]
        x = self.decoder(x)
        return {
            "class_logits": self.class_head(x),  # [B,Q,C]
            "bbox_preds": self.bbox_head(x),  # [B,Q,bbox_dim]
        }

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.heads(self.image_backbone(image))
