"""Workload definitions: model + loss closure per training pipeline (port
of automoe_tpu/train/workloads.py): the BDD / CARLA experts
(`bdd_expert_workload`: detection, segmentation, drivable), the nuScenes
expert (`nuscenes_workload`, camera + LiDAR), its CARLA image-only 2D
fine-tune (`carla_nuscenes_2d_workload`), the standalone trajectory
policy (`policy_workload`: the 4-conv backbone or the deep residual
trunk) and the gating network over the full AutoMoE (`gating_workload`).

Training options, as in the JAX package's factories:
  * dtype=torch.bfloat16 runs the forward under autocast (bf16 convs and
    matmuls) while parameters, their gradients and the optimizer stay
    float32; the outputs are cast to float32 before the loss, so losses
    reduce in float32;
  * remat and qat build the ResNet-18 trunks with checkpointed blocks and
    int8 fake-quant (models/resnet.py);
  * augment crops, flips and jitters train batches on the device
    (ops/augment.py) with parameters drawn from the step's key;
    validation is never augmented.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from automoe_tpu_torch.configs import AutoMoEConfig, load_model_config
from automoe_tpu_torch.losses.detection import (
    get_matcher,
    detection_set_loss,
    scatter_matched_targets,
)
from automoe_tpu_torch.losses.nuscenes import nuscenes_set_loss
from automoe_tpu_torch.losses.segmentation import segmentation_loss
from automoe_tpu_torch.losses.trajectory import gating_losses, policy_losses
from automoe_tpu_torch.models.automoe import AutoMoE, expert_param_mask, init_parameters
from automoe_tpu_torch.models.experts import (
    BDDDetectionExpert,
    BDDDrivableExpert,
    BDDSegmentationExpert,
    NuScenesExpert,
    NuScenesImage2DHead,
)
from automoe_tpu_torch.models.deep_policy import DeepTrajectoryPolicy
from automoe_tpu_torch.models.policy import TrajectoryPolicy
from automoe_tpu_torch.ops.boxes import box_convert
from automoe_tpu_torch.ops.masked import masked_cross_entropy, masked_smooth_l1

# loss_fn(model, batch, train, key=None) -> (loss, metrics): batch holds
# tensors on the model's device, images NHWC as the loaders give them;
# key (a tuple of ints, train/step.py) seeds what the loss draws itself
LossFn = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

#: folded into a step's key for its augmentation draw (the JAX package
#: folds the same constant into its step key)
AUGMENT_FOLD = 0x41554721
#: folded into a step's key for its routing-noise draw
ROUTING_FOLD = 0x524f5554


def autocast(device: torch.device, dtype: torch.dtype):
    """bf16 autocast on `device` for dtype=torch.bfloat16, else nothing."""
    if dtype == torch.bfloat16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    if dtype != torch.float32:
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    return contextlib.nullcontext()


def _float(out):
    """Model outputs in float32 (dicts and lists of tensors included)."""
    if torch.is_tensor(out):
        return out.float()
    if isinstance(out, dict):
        return {k: _float(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_float(v) for v in out)
    return out


def _train_augment(enabled: bool, labels: str):
    """(batch, train, key) -> the batch, augmented in train mode when
    enabled, its `labels` ("boxes" or "mask") moved with the image. The
    parameters are drawn from the step's key (without one, from torch's
    default generator)."""
    from automoe_tpu_torch.ops.augment import (AugmentConfig, augment_detection,
                                               augment_segmentation, params_to,
                                               sample_params)
    from automoe_tpu_torch.train.step import seed_from

    cfg = AugmentConfig()

    def apply(batch, train, key):
        if not (enabled and train):
            return batch
        gen = torch.Generator().manual_seed(
            int(torch.randint(0, 2**31 - 1, ())) if key is None
            else seed_from((*key, AUGMENT_FOLD)))
        image = batch["image"]
        params = params_to(sample_params(gen, image.shape[0], cfg), image.device)
        return (augment_detection(batch, params, cfg) if labels == "boxes"
                else augment_segmentation(batch, params))

    return apply


@dataclasses.dataclass
class Workload:
    name: str
    build_model: Callable[[], nn.Module]
    loss_fn: LossFn
    # model -> {parameter name: trainable}; None trains every parameter
    trainable_mask_fn: Optional[Callable[[nn.Module], Dict[str, bool]]] = None
    # under a mesh of several ranks: BatchNorm over the data group (the
    # JAX mesh's global-batch statistics); expert parallelism keeps its own
    cross_rank_bn: bool = True
    # under a mesh of several ranks: called after each train call (expert
    # parallelism's BatchNorm statistics sync, parallel/ep.py)
    after_step: Optional[Callable[[nn.Module], None]] = None
    # (mesh, microbatches): the model's pipeline_blocks run pipelined over
    # the mesh's 'model' group, each rank holding its stage (parallel/pp.py)
    pipeline: Optional[Tuple[Any, int]] = None

    def stage_names(self, model: nn.Module):
        """The parameters that live on their pipeline stage's ranks only."""
        if self.pipeline is None:
            return set()
        from automoe_tpu_torch.parallel.pp import pp_state_shardings

        return pp_state_shardings(model)

    def trainable_mask(self, model: nn.Module) -> Optional[Dict[str, bool]]:
        return self.trainable_mask_fn(model) if self.trainable_mask_fn else None

    def init_model(self, seed: int, device) -> nn.Module:
        """The model with seeded weights (drawn on the CPU from one
        torch.Generator, so a seed gives the same weights on every
        device), moved to `device`. Parameters the trainable mask freezes
        get requires_grad=False, so no backward runs through them; the
        optimizer gives them no update (the JAX package's masked update)."""
        model = self.build_model()
        init_parameters(model, torch.Generator().manual_seed(seed))
        if self.pipeline is not None:
            from automoe_tpu_torch.parallel.pp import pp_shard_state

            mesh, microbatches = self.pipeline
            pp_shard_state(model, mesh, microbatches=microbatches)
        mask = self.trainable_mask(model) or {}
        for name, p in model.named_parameters():
            p.requires_grad_(mask.get(name, True))
        return model.to(device).train()


def default_matcher(device) -> str:
    """The CUDA auction kernel on the card, the vectorised auction
    elsewhere (as the JAX package picks its Pallas kernel on the TPU)."""
    return "auction_kernel" if torch.device(device).type == "cuda" else "auction"


def bdd_expert_workload(task: str, *, num_classes: Optional[int] = None,
                        bbox_loss_weight: float = 2.0, cost_class: float = 1.0,
                        cost_bbox: float = 5.0, cost_giou: float = 2.0,
                        matcher: Optional[str] = None, dtype: torch.dtype = torch.float32,
                        remat: bool = False, qat: bool = False,
                        augment: bool = False) -> Workload:
    """BDD100K expert training and its CARLA fine-tune (the same workload
    over another data source). Detection: matcher None is
    `default_matcher` of the device the batch lies on, and validation adds
    the reference's per-batch avg_iou / recall_0.5 from the loss's own
    matching. Segmentation (19 classes) and drivable (3): CE with ignore
    label 255, and validation adds pixel_acc / mean_iou. Batches hold NHWC
    images; the image size and box cap are the data's."""
    C = {"detection": 10, "segmentation": 19, "drivable": 3}[task] \
        if num_classes is None else num_classes
    opts = dict(remat=remat, qat=qat)
    if task != "detection":
        return _seg_like_workload(task, C, dtype, opts, augment)
    augmented = _train_augment(augment, "boxes")

    def loss_fn(model, batch, train, key=None):
        batch = augmented(batch, train, key)
        image = batch["image"]
        with autocast(image.device, dtype):
            out = _float(model(image.permute(0, 3, 1, 2)))
        res = detection_set_loss(
            out["class_logits"], out["bbox_deltas"], batch["bboxes"], batch["labels"],
            num_classes=C, bbox_loss_weight=bbox_loss_weight, cost_class=cost_class,
            cost_bbox=cost_bbox, cost_giou=cost_giou,
            matcher=matcher or default_matcher(image.device))
        metrics = {"class_loss": res["class_loss"], "bbox_loss": res["bbox_loss"]}
        if not train:
            from automoe_tpu_torch.evals.detection import matched_iou_recall

            B, _, hh, ww = out["class_logits"].shape
            pred_boxes = out["bbox_deltas"].permute(0, 2, 3, 1).reshape(B, hh * ww, 4)
            si, sr, has = matched_iou_recall(pred_boxes, batch["bboxes"], res["query_idx"],
                                             res["valid"])
            denom = torch.clamp(has.sum(), min=1)
            metrics["avg_iou"] = torch.where(has, si, torch.zeros_like(si)).sum() / denom
            metrics["recall_0.5"] = torch.where(has, sr, torch.zeros_like(sr)).sum() / denom
        return res["loss"], metrics

    return Workload(name=f"bdd_{task}",
                    build_model=lambda: BDDDetectionExpert(num_classes=C, **opts),
                    loss_fn=loss_fn)


def _seg_like_workload(task: str, C: int, dtype: torch.dtype, opts: Dict[str, bool],
                       augment: bool) -> Workload:
    augmented = _train_augment(augment, "mask")

    def loss_fn(model, batch, train, key=None):
        batch = augmented(batch, train, key)
        image = batch["image"]
        with autocast(image.device, dtype):
            logits = _float(model(image.permute(0, 3, 1, 2)))  # [B,C,H,W]
        res = segmentation_loss(logits, batch["mask"])
        metrics = {}
        if not train:
            from automoe_tpu_torch.evals.segmentation import seg_metrics

            metrics = seg_metrics(logits, batch["mask"], num_classes=C)
        return res["loss"], metrics

    model = BDDSegmentationExpert if task == "segmentation" else BDDDrivableExpert
    return Workload(name=f"bdd_{task}", build_model=lambda: model(num_classes=C, **opts),
                    loss_fn=loss_fn)


# ---------------------------------------------------------------------------
# nuScenes expert and its CARLA 2D fine-tune
# ---------------------------------------------------------------------------

def nuscenes_workload(*, num_queries: int = 100, bbox_dim: int = 7, use_lidar: bool = True,
                      use_tnet: bool = False, fusion: str = "concat",
                      bbox_loss_weight: float = 5.0,
                      matcher: Optional[str] = None, dtype: torch.dtype = torch.float32,
                      remat: bool = False, qat: bool = False) -> Workload:
    """nuScenes expert training: camera (+ LiDAR points through the
    PointNet), the set loss of `losses/nuscenes.py` with `default_matcher`
    of the batch's device unless `matcher` names one. No augmentation, as
    in the JAX package."""

    def loss_fn(model, batch, train, key=None):
        image = batch["image"]
        with autocast(image.device, dtype):
            out = _float(model(image.permute(0, 3, 1, 2), batch.get("lidar")))
        res = nuscenes_set_loss(out["class_logits"], out["bbox_preds"], batch["boxes"],
                                batch["labels"], bbox_loss_weight=bbox_loss_weight,
                                matcher=matcher or default_matcher(image.device))
        return res["loss"], {"class_loss": res["class_loss"], "bbox_loss": res["bbox_loss"]}

    return Workload(
        name="nuscenes",
        build_model=lambda: NuScenesExpert(num_queries=num_queries, fusion=fusion,
                                           use_lidar=use_lidar, use_tnet=use_tnet,
                                           bbox_dim=bbox_dim, remat=remat, qat=qat),
        loss_fn=loss_fn)


def carla_nuscenes_2d_workload(*, num_queries: int = 196, num_classes: int = 10,
                               bbox_loss_weight: float = 1.0,
                               matcher: Optional[str] = None,
                               dtype: torch.dtype = torch.float32, remat: bool = False,
                               qat: bool = False, augment: bool = False) -> Workload:
    """The nuScenes → CARLA image-only 2D fine-tune (the reference's
    train_carla_nuscenes_expert_2d_ddp.py): xyxy targets as cxcywh, an
    exact match ('hungarian': K2 alone on the card, scipy on the CPU,
    unless `matcher` names another), CE over matched queries only (ignore
    index C) and SmoothL1
    over matched queries, weight 1.0. With augment, train batches are
    augmented as the detection expert's (pixel xyxy boxes)."""
    augmented = _train_augment(augment, "boxes")

    def loss_fn(model, batch, train, key=None):
        batch = augmented(batch, train, key)
        image = batch["image"]
        with autocast(image.device, dtype):
            out = _float(model(image.permute(0, 3, 1, 2)))
        logits, boxes = out["pred_logits"], out["pred_boxes"]
        B, Q, C = logits.shape
        tgt = box_convert(batch["bboxes"].float(), "xyxy", "cxcywh")
        qidx, valid = get_matcher(matcher or "hungarian")(
            logits, boxes, tgt, batch["labels"])
        tc, tb = scatter_matched_targets(qidx, valid, tgt, batch["labels"], Q, C)
        cls_loss = masked_cross_entropy(logits.reshape(B * Q, C), tc.reshape(B * Q),
                                        ignore_index=C)
        box_loss = masked_smooth_l1(boxes.reshape(B * Q, 4), tb.reshape(B * Q, 4),
                                    tc.reshape(B * Q) != C)
        return cls_loss + bbox_loss_weight * box_loss, {"class_loss": cls_loss,
                                                        "bbox_loss": box_loss}

    return Workload(
        name="carla_nuscenes_2d",
        build_model=lambda: NuScenesImage2DHead(num_queries=num_queries,
                                                num_classes=num_classes, remat=remat, qat=qat),
        loss_fn=loss_fn)


# ---------------------------------------------------------------------------
# CARLA trajectory policy
# ---------------------------------------------------------------------------

def policy_workload(*, horizon: int = 8, context_dim: int = 0, backbone_dim: int = 512,
                    image_size: int = 256, dtype: torch.dtype = torch.float32,
                    trunk_depth: int = 0, trunk_width: int = 128, pipeline_mesh=None,
                    pipeline_microbatches: int = 0) -> Workload:
    """Standalone TrajectoryPolicy training (the reference's
    train_carla_policy.py): loss = ADE + 2 FDE + 0.2 speed L1 + 0.1
    smoothness. With context_dim > 0 the batch's `context` vector feeds
    the heads. trunk_depth > 0 swaps EasyBackbone for the deep residual
    GroupNorm trunk (models/deep_policy.py::DeepTrajectoryPolicy) of
    trunk_depth blocks of trunk_width channels. With pipeline_mesh and
    pipeline_microbatches M > 0 the trunk runs pipeline-parallel over the
    mesh's 'model' group (parallel/pp.py::grouped_pipeline_apply), each
    rank holding its stage's blocks. image_size is the JAX signature's:
    the port's models take any input size, so nothing here reads it."""
    del image_size
    pipeline = None
    if pipeline_microbatches > 0:
        if trunk_depth <= 0:
            raise ValueError("pipeline_microbatches needs trunk_depth > 0 (only the deep "
                             "trunk is stage-partitionable)")
        if pipeline_mesh is None:
            raise ValueError("pipeline_microbatches needs pipeline_mesh")
        pipeline = (pipeline_mesh, pipeline_microbatches)

    def build_model():
        if trunk_depth > 0:
            return DeepTrajectoryPolicy(horizon=horizon, context_dim=context_dim,
                                        backbone_dim=backbone_dim, depth=trunk_depth,
                                        width=trunk_width)
        return TrajectoryPolicy(horizon=horizon, context_dim=context_dim,
                                backbone_dim=backbone_dim)

    def loss_fn(model, batch, train, key=None):
        ctx = batch.get("context") if context_dim > 0 else None
        image = batch["image"]
        with autocast(image.device, dtype):
            out = _float(model(image.permute(0, 3, 1, 2), ctx))
        res = policy_losses(out, batch["waypoints"], batch["speed"])
        return res["loss"], {k: v for k, v in res.items() if k != "loss"}

    return Workload(name="carla_policy", build_model=build_model, loss_fn=loss_fn,
                    pipeline=pipeline)


# ---------------------------------------------------------------------------
# Gating network (full AutoMoE, frozen experts)
# ---------------------------------------------------------------------------

def pooled_feature_dim(ecfg) -> int:
    """Width of an expert's parameter-free pooled extractor input (the
    extractors' pooling before their MLPs)."""
    if ecfg.type == "detection":
        return ecfg.num_classes + 4
    if ecfg.type in ("segmentation", "drivable"):
        return ecfg.num_classes
    return ecfg.num_queries * (ecfg.num_classes + ecfg.bbox_dim)


def gating_workload(model_config: Any, *, loss_config: Optional[Mapping] = None,
                    freeze_experts: bool = True, dtype: torch.dtype = torch.float32,
                    cache_features: bool = False, experts_eval: bool = False) -> Workload:
    """Gating training over the full AutoMoE (the reference's
    train_gating_network.py): the experts are frozen (no gradient, no
    update) while the extractors, context encoder, gating network and
    policy head train. As in the JAX package's default, the frozen
    experts still run in train mode: their BatchNorm normalises with batch
    statistics and its running statistics move, and their dropout is live.

    experts_eval: the frozen experts run in eval mode instead (frozen BN,
    no dropout; `AutoMoE.forward`). cache_features: the expert trunks do
    not run at all; batches carry the cached `expert_pooled_{i}` features
    (train/feature_cache.py::PooledFeatureDataset), which is exactly the
    experts_eval step. The experts' modules stay in the model either way,
    so their weights and statistics stay in the state dict untouched.

    With gating.honor_topk_in_composite and top_k > 0, a train step routes
    top-k over noisy logits; the noise comes from a generator seeded from
    the step's key (so from --seed), and a step without a key raises, as
    a missing 'gating' RNG stream does in the JAX package. The noise is
    drawn on the CPU, so the card and the CPU route alike."""
    from automoe_tpu_torch.train.feature_cache import pooled_keys

    cfg: AutoMoEConfig = load_model_config(model_config)
    lcfg = dict(loss_config or {})
    names = pooled_keys(len(cfg.experts))

    def loss_fn(model, batch, train, key=None):
        kw: Dict[str, Any] = {}
        if cache_features:
            kw["cached_pooled"] = [batch[k] for k in names]
            batch = {k: v for k, v in batch.items() if k not in names}
        elif experts_eval:
            kw["experts_eval"] = True
        if key is not None:
            from automoe_tpu_torch.parallel.mesh import active_mesh
            from automoe_tpu_torch.train.step import seed_from

            kw["generator"] = torch.Generator().manual_seed(seed_from((*key, ROUTING_FOLD)))
            # dropout drawn part by part from the key and the data index, so
            # expert parallelism (parallel/ep.py), which runs one expert a
            # rank, draws what this dense forward draws
            mesh = active_mesh()
            kw["rng_key"] = (*key, 0 if mesh is None else mesh.data_index)
        with autocast(batch["image"].device, dtype):
            out = _float(model(batch, **kw))
        res = gating_losses(out, batch["waypoints"], batch["speed"], lcfg)
        return res["total_loss"], {k: v for k, v in res.items() if k != "total_loss"}

    return Workload(
        name="gating", build_model=lambda: AutoMoE(cfg), loss_fn=loss_fn,
        trainable_mask_fn=(lambda m: expert_param_mask(m.named_parameters()))
        if freeze_experts else None)
