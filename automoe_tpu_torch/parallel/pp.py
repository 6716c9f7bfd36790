"""Pipeline parallelism (port of automoe_tpu/parallel/pp.py): blocks split
by stage over the mesh's 'model' group, GPipe-style microbatching.

The JAX package runs the pipeline as a `lax.scan` over S + M - 1 ticks
inside `shard_map`; here every rank of a model group runs the same loop
over the ticks on its own stage:

  * each tick, stage 0 takes a fresh microbatch (zeros while draining,
    `torch.where` on the stage index, as JAX's `jnp.where`), every rank
    applies its stage to its buffer, and the buffers rotate one stage
    forward (`Mesh.permute`, an autograd Function whose backward rotates
    the gradient back: what `jax.grad` of `lax.ppermute` gives);
  * stage S - 1's emissions of ticks S - 1 .. S + M - 2 (microbatch m
    finishes at tick m + S - 1) are collected with a `where` on the stage
    index, not a mask product (a block non-finite at zero runs on the
    drain's zero buffers, and 0 * inf would leak NaN), and summed over the
    model group, so every stage leaves with the output;
  * the backward schedule is autograd's: the transposes of the where, the
    rotations and the sum (`parallel/mesh.py`'s gradient rule);
  * remat per tick (default, GPipe's memory profile): each tick's stage
    application is a `torch.utils.checkpoint`, so the backward keeps only
    the stage inputs and recomputes the rest.

Constraints, as in JAX: blocks are shape-preserving and sample-independent
(no BatchNorm batch statistics across microbatches); the batch divides by
the microbatch count; the bubble fraction is (S-1)/(S-1+M).

A rank holds only its stage's parameters: `stage_param_sharding(mesh)`
cuts stage s's slice of [S, ...] (or [L, ...]) stacked leaves, the
counterpart of placing them with JAX's `P('model')`; `pp_shard_state`
does it to a model's `pipeline_blocks` in place (their optimizer moments
and EMA then live on the stage's ranks only) and returns their names,
whose gradients the trainer reduces over the data group alone and whose
squares it sums over the model group for the global-norm clip.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Set

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from automoe_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

Params = Dict[str, torch.Tensor]

#: the deep policy's stacked-trunk submodule (models/deep_policy.py)
PIPELINE_BLOCKS = "pipeline_blocks"


def stage_param_sharding(mesh: Mesh) -> Callable[[Any], Any]:
    """fn(stacked) -> this rank's stage: every leaf of the dict (tensor or
    numpy array) with a leading [S·k] axis cut to its stage's k
    consecutive rows (stage s owns rows [s·k, (s+1)·k))."""
    S, s = mesh.shape[MODEL_AXIS], mesh.model_index

    def place(stacked):
        out = {}
        for k, v in stacked.items():
            L = v.shape[0]
            if L % S:
                raise ValueError(f"block count {L} must divide by the mesh 'model' "
                                 f"axis ({S})")
            per = L // S
            out[k] = torch.as_tensor(v)[s * per:(s + 1) * per]
        return out

    return place


def pipeline_apply(block_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stage_params: Params, x: torch.Tensor, mesh: Mesh, *,
                   microbatches: int, remat: bool = True) -> torch.Tensor:
    """y = block_S(...block_2(block_1(x))), stages pipelined over 'model'.

    stage_params: this rank's stage, leaves [1, ...] (stage_param_sharding
    of an [S]-stacked dict). x: this data row's [B, ...] batch, the same
    on every rank of the model group, B divisible by microbatches.
    block_fn(params, h) -> h', shape-preserving, sample-independent.
    Returns y with x's shape on every rank of the model group."""
    S, data = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
    if microbatches < 1:
        raise ValueError("microbatches must be >= 1")
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B * data} must divide by data axis ({data}) x "
                         f"microbatches ({microbatches})")
    params = {k: v[0] for k, v in stage_params.items()}
    idx = mesh.model_index
    mb = B // microbatches
    xs = x.reshape((microbatches, mb) + tuple(x.shape[1:]))
    zeros = x.new_zeros(xs.shape[1:])
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == S - 1, device=x.device)
    if remat and torch.is_grad_enabled():
        def apply(p, h):
            return checkpoint(block_fn, p, h, use_reentrant=False)
    else:
        apply = block_fn
    ticks = microbatches + S - 1
    cur = zeros
    ys = []
    for t in range(ticks):
        cur = torch.where(first, xs[t] if t < microbatches else zeros, cur)
        y = apply(params, cur)
        ys.append(y)
        if t < ticks - 1:  # the last tick's rotation would feed nothing
            cur = mesh.permute(y, 1, "model")
    out = torch.stack(ys[S - 1:])  # [M, mb, ...]: stage S-1's real emissions
    out = mesh.sum(torch.where(last, out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device)), "model")
    return out.reshape(x.shape)


def grouped_pipeline_apply(block_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                           stage_params: Params, x: torch.Tensor, mesh: Mesh, *,
                           microbatches: int, remat: bool = True) -> torch.Tensor:
    """`pipeline_apply` for trunks deeper than the mesh: stage_params
    leaves carry this stage's L/S consecutive blocks ([L/S, ...], what
    stage_param_sharding cuts from [L, ...]); the stage applies them in a
    row. The entry the deep policy trunk uses; L == S is pipeline_apply."""

    def stage_fn(params_stage, h):
        return sequential_apply(block_fn, params_stage, h)

    grouped = {k: v[None] for k, v in stage_params.items()}
    return pipeline_apply(stage_fn, grouped, x, mesh, microbatches=microbatches,
                          remat=remat)


def sequential_apply(block_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                     stacked: Params, x: torch.Tensor) -> torch.Tensor:
    """The reference semantics: the stacked blocks in a row on one rank
    (block l reads slice l of every leaf)."""
    depth = next(iter(stacked.values())).shape[0]
    for i in range(depth):
        x = block_fn({k: v[i] for k, v in stacked.items()}, x)
    return x


def pp_state_shardings(model: nn.Module, token: str = PIPELINE_BLOCKS) -> Set[str]:
    """Names of the parameters (and so of their optimizer moments and EMA)
    that live on their stage's ranks only: those whose path holds `token`;
    everything else is replicated."""
    return {n for n, _ in model.named_parameters() if token in n.split(".")}


@torch.no_grad()
def pp_shard_state(model: nn.Module, mesh: Mesh, *, microbatches: int,
                   token: str = PIPELINE_BLOCKS) -> Set[str]:
    """Cut every `token` submodule's [L]-stacked parameters to this rank's
    stage, in place, and make it run through grouped_pipeline_apply with
    `microbatches`. Returns the stage-local parameter names."""
    place = stage_param_sharding(mesh)
    for name, module in model.named_modules():
        if name.split(".")[-1] != token:
            continue
        local = place(dict(module.named_parameters(recurse=False)))
        for k, v in local.items():
            getattr(module, k).data = v.clone()
        module.pipeline = (mesh, microbatches)
    return pp_state_shardings(model, token)


def mlp_block(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Demo stage: norm-free residual FFN block h + relu(h W1 + b1) W2 + b2."""
    return h + torch.relu(h @ params["w1"] + params["b1"]) @ params["w2"] + params["b2"]


def init_mlp_stack(rng, stages: int, dim: int, hidden: int) -> Dict[str, np.ndarray]:
    """[S]-stacked parameters of `mlp_block`, host numpy (the JAX
    package's draws for the same seed)."""
    r = np.random.default_rng(rng)
    scale1 = (2.0 / dim) ** 0.5
    scale2 = (2.0 / hidden) ** 0.5
    return {
        "w1": (r.normal(size=(stages, dim, hidden)) * scale1).astype(np.float32),
        "b1": np.zeros((stages, hidden), np.float32),
        "w2": (r.normal(size=(stages, hidden, dim)) * scale2).astype(np.float32),
        "b2": np.zeros((stages, dim), np.float32),
    }
