"""The perception experts (port of automoe_tpu/models/experts.py), NCHW.

Dense-map outputs are [B,C,h,w]; the nuScenes expert's query outputs are
[B,Q,C] as in the JAX package. Each expert splits into its trunk and a
`heads` method over the trunk features, so the int8 serving path
(serving/quant.py) runs the very same head modules over its int8 trunk.

The nuScenes expert's LiDAR branch is a PointNet (with its two TNets
under use_tnet) over [B,P,3] points, its per-point layers `nn.Conv1d`
with kernel 1 over [B,C,P] and its norms `nn.BatchNorm1d` (torch's
BatchNorm is the JAX package's TorchBatchNorm: momentum 0.1 in torch's
terms, eps 1e-5, unbiased running variance). `NuScenesImage2DHead` is the
image-only 2D fine-tune head. Module names are the reference's.
`remat` and `qat` (training options of the ResNet-18 trunk,
models/resnet.py) leave the state dict unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional

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

    def __init__(self, num_classes: int = 10, *, remat: bool = False, qat: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNet18Backbone(remat=remat, qat=qat, device=device, dtype=dtype)
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

    def __init__(self, num_classes: int = 19, *, upsample: bool = True, remat: bool = False,
                 qat: bool = False, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.upsample = upsample
        self.backbone = ResNet18Backbone(remat=remat, qat=qat, device=device, dtype=dtype)
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

    def __init__(self, num_classes: int = 3, *, upsample: bool = True, remat: bool = False,
                 qat: bool = False, device=None, dtype=None):
        super().__init__(num_classes, upsample=upsample, remat=remat, qat=qat,
                         device=device, dtype=dtype)


def _point_layers(m: nn.Module, in_channels: int, out_dim: int, fk) -> None:
    """The layers a TNet and a PointNet share: per-point conv1..3 (k=1) to
    64, 128, 1024 channels, fc1..3 to 512, 256, out_dim, bn1..5."""
    m.conv1 = nn.Conv1d(in_channels, 64, 1, **fk)
    m.conv2 = nn.Conv1d(64, 128, 1, **fk)
    m.conv3 = nn.Conv1d(128, 1024, 1, **fk)
    m.fc1 = nn.Linear(1024, 512, **fk)
    m.fc2 = nn.Linear(512, 256, **fk)
    m.fc3 = nn.Linear(256, out_dim, **fk)
    for j, c in enumerate((64, 128, 1024, 512, 256), 1):
        setattr(m, f"bn{j}", nn.BatchNorm1d(c, eps=1e-5, momentum=0.1, **fk))


class TNet(nn.Module):
    """PointNet alignment net: a k×k transform per cloud from [B,k,P]."""

    def __init__(self, k: int = 3, *, device=None, dtype=None):
        super().__init__()
        self.k = k
        _point_layers(self, k, k * k, dict(device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = torch.relu(self.bn3(self.conv3(h)))
        h = h.amax(dim=2)  # [B,1024]; ties share the gradient, as jnp.max's
        h = torch.relu(self.bn4(self.fc1(h)))
        h = torch.relu(self.bn5(self.fc2(h)))
        h = self.fc3(h) + torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return h.reshape(-1, self.k, self.k)


class PointNet(nn.Module):
    """PointNet encoder: points [B,P,3] → [B,output_dim]. Per-point MLP
    (optionally aligned by the input and feature TNets), max over the
    points (zero-padded points included), head MLP with dropout 0.3 after
    fc1 and fc2."""

    def __init__(self, output_dim: int = 1024, use_tnet: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.use_tnet = use_tnet
        if use_tnet:
            self.input_transform = TNet(3, **fk)
            self.feature_transform = TNet(64, **fk)
        _point_layers(self, 3, output_dim, fk)
        self.dropout = nn.Dropout(0.3)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x = points.transpose(1, 2)  # [B,3,P]
        # the JAX package's einsum("bij,bnj->bni", T, x) is T @ x here
        if self.use_tnet:
            x = torch.bmm(self.input_transform(x), x)
        h = torch.relu(self.bn1(self.conv1(x)))
        if self.use_tnet:
            h = torch.bmm(self.feature_transform(h), h)
        h = torch.relu(self.bn2(self.conv2(h)))
        h = torch.relu(self.bn3(self.conv3(h)))
        h = h.amax(dim=2)
        h = self.dropout(torch.relu(self.bn4(self.fc1(h))))
        h = self.dropout(torch.relu(self.bn5(self.fc2(h))))
        return self.fc3(h)


class NuScenesImage2DHead(nn.Module):
    """The image-only 2D detection head of the CARLA fine-tune (the
    reference's `ImageOnlyWrapper`): ResNet-18 (+pool) → 256-d projection,
    learned queries added to the broadcast scene feature, MLP 256→256→128
    with dropout 0.1, class head and 4-dim (cxcywh) box head."""

    def __init__(self, num_queries: int = 196, num_classes: int = 10, *,
                 remat: bool = False, qat: bool = False, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.image_backbone = ResNet18Backbone(include_pool=True, remat=remat, qat=qat, **fk)
        self.image_projection = nn.Linear(512, 256, **fk)
        self.query_embed = nn.Embedding(num_queries, 256, **fk)
        self.mlp = nn.Sequential(
            nn.Linear(256, 256, **fk), nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(256, 128, **fk), nn.ReLU(), nn.Dropout(0.1),
        )
        self.class_head = nn.Linear(128, num_classes, **fk)
        self.box_head = nn.Linear(128, 4, **fk)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        feat = self.image_projection(self.image_backbone(image))
        x = self.mlp(feat[:, None, :] + self.query_embed.weight[None, :, :])
        return {"pred_logits": self.class_head(x),  # [B,Q,C]
                "pred_boxes": self.box_head(x)}  # [B,Q,4]


class NuScenesExpert(nn.Module):
    """Camera(+LiDAR) DETR-lite: the global scene feature (the image's,
    fused with the PointNet's under use_lidar: concatenated, 512 wide, or
    summed, 256) broadcast over learned queries → MLP decoder →
    class/bbox heads."""

    def __init__(self, num_queries: int = 100, fusion: str = "concat",
                 use_lidar: bool = False, use_tnet: bool = False,
                 bbox_dim: int = 7, num_classes: int = 10, *, remat: bool = False,
                 qat: bool = False, device=None, dtype=None):
        super().__init__()
        if fusion not in ("concat", "sum"):
            raise ValueError(f"unknown fusion {fusion!r}")
        fk = dict(device=device, dtype=dtype)
        self.use_lidar = use_lidar
        self.fusion = fusion
        self.fusion_dim = 512 if (use_lidar and fusion == "concat") else 256
        self.image_backbone = ResNet18Backbone(include_pool=True, remat=remat, qat=qat, **fk)
        self.image_projection = nn.Linear(512, 256, **fk)
        if use_lidar:
            self.lidar_backbone = PointNet(256, use_tnet, **fk)
        self.query_embed = nn.Embedding(num_queries, self.fusion_dim, **fk)
        self.decoder = nn.Sequential(
            nn.Linear(self.fusion_dim, 256, **fk), nn.ReLU(), nn.Dropout(0.3),
            nn.Linear(256, 128, **fk), nn.ReLU(), nn.Dropout(0.3),
        )
        self.class_head = nn.Linear(128, num_classes, **fk)
        self.bbox_head = nn.Linear(128, bbox_dim, **fk)

    def heads(self, img_feat: torch.Tensor,
              lidar: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """[B,512] pooled image feature (+ [B,P,3] points) →
        {class_logits, bbox_preds}. Without points the image feature
        alone is fused, as in the JAX package (which a concat expert's
        512-wide queries then reject: AutoMoE passes zero points)."""
        fused = self.image_projection(img_feat)
        if self.use_lidar and lidar is not None:
            lidar_feat = self.lidar_backbone(lidar.to(fused.dtype))
            fused = (torch.cat([fused, lidar_feat], dim=-1) if self.fusion == "concat"
                     else fused + lidar_feat)
        x = fused[:, None, :] + self.query_embed.weight[None, :, :]
        x = self.decoder(x)
        return {
            "class_logits": self.class_head(x),  # [B,Q,C]
            "bbox_preds": self.bbox_head(x),  # [B,Q,bbox_dim]
        }

    def forward(self, image: torch.Tensor,
                lidar: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        return self.heads(self.image_backbone(image), lidar)
