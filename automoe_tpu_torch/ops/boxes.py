"""Box geometry (port of automoe_tpu/ops/boxes.py): `box_convert`,
`box_iou`, `generalized_box_iou` and the BEV footprint of 3D boxes, with
the JAX package's 1e-9 clamps on union and hull."""
from __future__ import annotations

import torch


def box_convert(boxes: torch.Tensor, in_fmt: str, out_fmt: str) -> torch.Tensor:
    """Convert boxes between 'xyxy' and 'cxcywh' formats. [..., 4] -> [..., 4]."""
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xyxy" and out_fmt == "cxcywh":
        x1, y1, x2, y2 = boxes.unbind(-1)
        return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)
    if in_fmt == "cxcywh" and out_fmt == "xyxy":
        cx, cy, w, h = boxes.unbind(-1)
        hw, hh = w * 0.5, h * 0.5
        return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)
    raise ValueError(f"unsupported conversion {in_fmt} -> {out_fmt}")


def _area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(boxes1: torch.Tensor, boxes2: torch.Tensor):
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(boxes1)[..., :, None] + _area(boxes2)[..., None, :] - inter
    return inter, union


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: [N,4] x [M,4] -> [N,M]."""
    inter, union = _inter_union(boxes1, boxes2)
    return inter / torch.clamp(union, min=1e-9)


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: [N,4] x [M,4] -> [N,M]
    (GIoU = IoU - (hull - union) / hull)."""
    inter, union = _inter_union(boxes1, boxes2)
    iou = inter / torch.clamp(union, min=1e-9)
    hull_lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    hull_rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    hull_wh = torch.clamp(hull_rb - hull_lt, min=0.0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    return iou - (hull - union) / torch.clamp(hull, min=1e-9)


def bev_from_3d(boxes7: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV xyxy footprint of 7-dim 3D boxes [cx,cy,cz,w,l,h,yaw]."""
    cx, cy = boxes7[..., 0], boxes7[..., 1]
    w, l = boxes7[..., 3], boxes7[..., 4]
    return torch.stack([cx - w * 0.5, cy - l * 0.5, cx + w * 0.5, cy + l * 0.5], -1)
