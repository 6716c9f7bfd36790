"""Expert parallelism (port of automoe_tpu/parallel/ep.py): the experts
spread over the mesh's 'model' group, one expert a rank.

Each rank of a model group runs only its own expert and that expert's
extractor; the [B, 256] features are all-gathered over the group into
[E, B, 256] (`Mesh.gather`, whose backward gives each rank the summed
gradient of its own slice), and the context encoder, gating network and
policy head run replicated on every rank. The model axis must equal the
number of experts. Gradients follow `parallel/mesh.py`'s rule: summed
over the world and divided by its size, an expert's and its extractor's
come from their own ranks only.

Training mode, as in the JAX package (the reference trainer's
`model.train()`: expert BatchNorm statistics move and dropout is live even
with the experts frozen):
  * dropout is drawn part by part from the step's key and the data index
    only (`models/automoe.py::seed_part`), so the ranks of a model group,
    which replicate gating, context and policy, draw the same masks, and
    a model group draws what the dense forward draws on the same rows;
    the routing noise comes from the key alone, as in the dense workload;
  * BatchNorm normalises with each data shard's own statistics (JAX EP's
    per-shard normalisation; the dense data-parallel path normalises over
    the global batch); after each train call the running statistics are
    combined (`sync_ep_batchnorm`): an expert's from its own ranks,
    averaged over the data group, everything else averaged over the data
    group (JAX: deltas summed over 'model', then averaged over 'data');
  * the load-balancing MSE is taken on the global mean usage
    (`losses/trajectory.py`, `parallel.mesh.data_mean`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from automoe_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _check(model_config, mesh: Mesh):
    from automoe_tpu_torch.configs import load_model_config

    cfg = load_model_config(model_config)
    E = len(cfg.experts)
    if mesh.shape[MODEL_AXIS] != E:
        raise ValueError(f"EP needs mesh model axis == {E} experts, got "
                         f"{mesh.shape[MODEL_AXIS]}")
    return cfg


def ep_forward(model, batch: Mapping[str, Any], mesh: Mesh, *,
               generator: Optional[torch.Generator] = None,
               rng_key=None) -> Dict[str, Any]:
    """The AutoMoE forward with this rank's expert only (`model` is the
    whole AutoMoE, its weights the same on every rank): the outputs of
    AutoMoE.forward without the raw per-expert outputs."""
    from automoe_tpu_torch.models.automoe import seed_part

    E = len(model.config.experts)  # == the model axis (make_ep_forward, the loss_fn check)
    image = batch["image"]
    if image.ndim != 4 or image.shape[-1] != 3:
        raise ValueError(f"expected NHWC image [B,H,W,3], got {tuple(image.shape)}")
    image = image.permute(0, 3, 1, 2)
    B, e = image.shape[0], mesh.model_index
    seed_part(rng_key, 1)
    context_features = model.context_features(batch, B, image.dtype, image.device)
    seed_part(rng_key, 100 + e)
    out = model.expert_output(e, image, batch)
    seed_part(rng_key, 200 + e)
    feat = model.extractor_feature(e, out, image.shape[2:])
    feats = mesh.gather(feat, "model")  # [E, B, 256]
    seed_part(rng_key, 2)
    return model.head_outputs(image, [feats[i] for i in range(E)], context_features,
                              generator=generator)


def make_ep_forward(config, mesh: Mesh, dtype: torch.dtype = torch.float32):
    """fn(model, batch) -> outputs: the expert-parallel eval forward (no
    gradient, eval mode, noise-free routing). `batch` is this data row's
    shard, the same on every rank of the model group."""
    from automoe_tpu_torch.train.workloads import autocast

    _check(config, mesh)

    @torch.no_grad()
    def fwd(model, batch):
        was = model.training
        model.eval()
        try:
            with autocast(batch["image"].device, dtype):
                return ep_forward(model, batch, mesh)
        finally:
            model.train(was)

    return fwd


def _gating_loss_terms(pred, batch, lcfg):
    """The gating loss on this rank's rows (losses/trajectory.py::
    gating_losses): linear terms are local means (the ranks' mean is the
    global one), the load-balancing MSE squares the global mean usage."""
    from automoe_tpu_torch.losses.trajectory import gating_losses

    res = gating_losses(pred, batch["waypoints"], batch["speed"], lcfg)
    return res["total_loss"], {k: v for k, v in res.items() if k != "total_loss"}


def ep_gating_loss_fn(model_config, mesh: Mesh, *, loss_config: Optional[Dict] = None,
                      dtype: torch.dtype = torch.float32):
    """The workload contract's loss_fn(model, batch, train, key) whose
    forward is `ep_forward`: a drop-in for the train and eval steps, so the
    Trainer drives expert parallelism without special cases."""
    from automoe_tpu_torch.train.workloads import ROUTING_FOLD, _float, autocast

    _check(model_config, mesh)
    lcfg = dict(loss_config or {})

    def loss_fn(model, batch, train, key=None):
        kw: Dict[str, Any] = {}
        if key is not None:
            from automoe_tpu_torch.train.step import seed_from

            kw["generator"] = torch.Generator().manual_seed(seed_from((*key, ROUTING_FOLD)))
            kw["rng_key"] = (*key, mesh.data_index)
        with autocast(batch["image"].device, dtype):
            pred = _float(ep_forward(model, batch, mesh, **kw))
        return _gating_loss_terms(pred, batch, lcfg)

    return loss_fn


def _owner(name: str) -> Optional[int]:
    """The expert index whose rank runs the module of a state name, or
    None for the replicated parts."""
    parts = name.split(".")
    if parts[0] == "experts":
        return int(parts[1])
    if parts[:2] == ["expert_extractors", "extractors"]:
        return int(parts[2])
    return None


@torch.no_grad()
def sync_ep_batchnorm(model: nn.Module, mesh: Mesh) -> None:
    """After a train call: every buffer (BatchNorm statistics and step
    counts) set to the data group's average of its owners' values: an
    expert's and its extractor's from the rank that ran them, the
    replicated parts' from every rank."""
    if mesh.size == 1:
        return
    me, D = mesh.model_index, mesh.shape[DATA_AXIS]
    bufs = [(n, b) for n, b in model.named_buffers()]
    for floating in (True, False):
        group = [(n, b) for n, b in bufs if b.is_floating_point() == floating]
        if not group:
            continue
        owners = [_owner(n) for n, _ in group]
        dtype = torch.float64 if floating else torch.int64
        flat = torch.cat([(b if o is None or o == me else torch.zeros_like(b))
                          .reshape(-1).to(dtype) for (_, b), o in zip(group, owners)])
        total = mesh.all_reduce(flat)
        off = 0
        for (_, b), o in zip(group, owners):
            v = total[off:off + b.numel()]
            denom = mesh.size if o is None else D
            b.copy_((v / denom if floating else v // denom).view_as(b).to(b.dtype))
            off += b.numel()


def ep_gating_workload(model_config, mesh: Mesh, *, loss_config: Optional[Dict] = None,
                       image_size: int = 256, freeze_experts: bool = True,
                       dtype: torch.dtype = torch.float32):
    """The gating Workload with expert-parallel execution: the counterpart
    of workloads.gating_workload (the same model and state names, loss and
    freezing), selected by `automoe-train-torch gating --parallelism ep`.
    image_size is the JAX signature's; the port's models take any size."""
    from automoe_tpu_torch.models.automoe import AutoMoE, expert_param_mask
    from automoe_tpu_torch.train.workloads import Workload

    del image_size
    cfg = _check(model_config, mesh)
    return Workload(
        name="gating_ep", build_model=lambda: AutoMoE(cfg),
        loss_fn=ep_gating_loss_fn(cfg, mesh, loss_config=loss_config, dtype=dtype),
        trainable_mask_fn=(lambda m: expert_param_mask(m.named_parameters()))
        if freeze_experts else None,
        cross_rank_bn=False, after_step=lambda m: sync_ep_batchnorm(m, mesh))


def make_ep_gating_train_step(config, mesh: Mesh, *, loss_config: Optional[Dict] = None,
                              dtype: torch.dtype = torch.float32):
    """step(model, optimizer, batch, key) -> metrics: one expert-parallel
    gating train step (the optimizer reduces the gradients over the mesh:
    `Optimizer.shard`), then the BatchNorm statistics sync; the metrics are
    averaged over the world."""
    from automoe_tpu_torch.train.step import make_train_step

    step = make_train_step(ep_gating_loss_fn(config, mesh, loss_config=loss_config,
                                             dtype=dtype))

    def train_step(model, optimizer, batch, key=None):
        metrics = step(model, optimizer, batch, key)
        sync_ep_batchnorm(model, mesh)
        return mesh.mean_metrics(metrics)

    return train_step
