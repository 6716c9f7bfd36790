"""Process groups as the port's mesh (port of automoe_tpu/parallel/mesh.py).

The JAX package drives every local device from one process and names a
`jax.sharding.Mesh` ('data', 'model'); GSPMD then inserts the
collectives. The port runs one process per card (a k-card host is k
processes; on the CPU, one process per rank) and its mesh is the world of
processes, split `data x model` in row-major order: rank = data_index *
model + model_index. Ranks of one model group (one data index) read the
same sampler shard and replicate whatever the workload does not split over
'model'; ranks of one data group (one model index) each read their own.

The world is started with the JAX CLI's flags: `--multihost --coordinator
host:port --num-processes N --process-id i` (`init_world`); without them it
is this process alone, a group of one, which issues no collective.

Backend: chosen once, from counts, before the group is made
(`choose_backend`): NCCL when every rank on the host has its own card,
gloo when there are more ranks than cards (several ranks sharing one card,
and every CPU run). gloo carries all_reduce, broadcast and barrier for
CUDA tensors but not all_gather or send/recv, so under gloo the helpers
here move CUDA tensors through host memory for every collective
(`Mesh.staging`); the compute stays on the card.

Gradients follow one rule (`Mesh.reduce_gradients`): every rank's
backward is the transpose of its forward, collectives included (an
all-reduce's backward all-reduces, an all-gather's backward sums the
gathered slices' gradients, a ring permute's backward rotates back), so
each rank holds its share of the gradient of the sum of the world's
losses; a replicated parameter's gradient is summed over the world and a
parameter held by one model rank (a pipeline stage) over its data group,
each then divided by the world size. The result is the gradient of the
mean of the ranks' losses, which every workload makes equal to the loss
of the single-process step on the global batch: per-sample means are
means over equal local batches, and a mean over a data-dependent count
(matched queries, pixels not ignored) divides its local sum by the data
group's mean count (`loss_denominator`).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: seconds a collective (and the rendezvous) may wait for the other ranks
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 = absorb all remaining processes."""

    data: int = -1
    model: int = 1


def choose_backend(device_type: str, num_processes: int,
                   cuda_count: Optional[int] = None) -> str:
    """'nccl' when each of the host's `num_processes` ranks has its own
    card, else 'gloo' (more ranks than cards, or the CPU). Decided from the
    counts before the group exists, never after a failure."""
    if device_type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count() if cuda_count is None else cuda_count
    return "nccl" if 0 < num_processes <= cards else "gloo"


def init_world(coordinator: str, num_processes: int, process_id: int,
               device: Optional[str] = None) -> Tuple[str, torch.device]:
    """Join the world of `num_processes` ranks at `coordinator` (host:port)
    as rank `process_id` (the JAX CLI's --multihost flags). All ranks are
    taken to be on one host. Returns (backend, this rank's device): under
    NCCL rank i owns cuda:i; under gloo on CUDA the ranks share the cards
    round-robin."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialised")
    if not (0 <= process_id < num_processes):
        raise ValueError(f"--process-id {process_id} not in [0, {num_processes})")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    backend = choose_backend(dev.type, num_processes)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return backend, dev


class Mesh:
    """The world split data x model, with its subgroups and device.

    `shape` maps 'data' and 'model' to their sizes, as a JAX mesh's does.
    Every collective helper takes one of the groups ("world", "data",
    "model") and returns its input untouched when that group has one rank.
    """

    def __init__(self, data: int, model: int, device: torch.device):
        self.shape: Dict[str, int] = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = data * model
        self.device = device
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.data_index, self.model_index = divmod(self.rank, model)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        # gloo has no CUDA all_gather / send / recv: stage every collective
        self.staging = self.backend == "gloo" and device.type == "cuda"
        self._ranks = {
            "world": list(range(self.size)),
            "data": [d * model + self.model_index for d in range(data)],
            "model": [self.data_index * model + m for m in range(model)],
        }
        self._groups: Dict[str, object] = {"world": None}
        if self.size > 1:
            # every rank makes every subgroup, in the same order
            for m in range(model):
                g = dist.new_group([d * model + m for d in range(data)])
                if m == self.model_index:
                    self._groups["data"] = g
            for d in range(data):
                g = dist.new_group([d * model + m for m in range(model)])
                if d == self.data_index:
                    self._groups["model"] = g

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]}, rank {self.rank}, "
                f"backend {self.backend or 'none'}, staging {self.staging_label})")

    @property
    def staging_label(self) -> str:
        return "host" if self.staging else "none"

    def group_size(self, group: str) -> int:
        return len(self._ranks[group])

    def group_index(self, group: str) -> int:
        return self._ranks[group].index(self.rank)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # -- plain collectives (no autograd) ------------------------------------

    def _staged(self, t: torch.Tensor, op) -> torch.Tensor:
        """op(tensor) in place, on a host copy when the backend has no
        CUDA path; returns the result on t's device."""
        if self.staging and t.is_cuda:
            h = t.detach().to("cpu", copy=True)
            op(h)
            return h.to(t.device)
        op(t)
        return t

    def all_reduce(self, x: torch.Tensor, group: str = "world") -> torch.Tensor:
        """The sum of x over `group` (a new tensor; x is not changed)."""
        if self.group_size(group) == 1:
            return x
        pg = self._groups[group]
        return self._staged(x.detach().clone(), lambda t: dist.all_reduce(t, group=pg))

    def all_gather(self, x: torch.Tensor, group: str = "world") -> torch.Tensor:
        """[n, *x.shape]: x of every rank of `group`, in group order."""
        n = self.group_size(group)
        if n == 1:
            return x[None]
        pg = self._groups[group]
        src = x.detach().contiguous()
        if self.staging and src.is_cuda:
            h = src.to("cpu")
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=pg)
            return torch.stack(parts).to(x.device)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=pg)
        return torch.stack(parts)

    def ring_shift(self, x: torch.Tensor, shift: int, group: str = "model") -> torch.Tensor:
        """The x of the rank `shift` places before this one in `group`'s
        ring (each rank sends its x `shift` places forward)."""
        ranks = self._ranks[group]
        n = len(ranks)
        if n == 1 or shift % n == 0:
            return x
        i = ranks.index(self.rank)
        dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
        send = x.detach().contiguous()
        if self.staging and send.is_cuda:
            send = send.to("cpu")
        recv = torch.empty_like(send)
        pg = self._groups[group]
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, pg),
                                       dist.P2POp(dist.irecv, recv, src, pg)])
        for r in reqs:
            r.wait()
        return recv.to(x.device)

    def all_to_all(self, x: torch.Tensor, send_counts: Sequence[int],
                   recv_counts: Sequence[int], group: str = "data") -> torch.Tensor:
        """x's rows split in `group` order by `send_counts` (the first
        send_counts[0] rows to the group's first rank, ...); returns the
        rows every rank sent here, concatenated in group order
        (sum(recv_counts) rows)."""
        if self.group_size(group) == 1:
            return x
        send = x.detach().contiguous()
        if self.staging and send.is_cuda:
            send = send.to("cpu")
        recv = send.new_empty((sum(recv_counts), *send.shape[1:]))
        dist.all_to_all_single(recv, send, list(recv_counts), list(send_counts),
                               group=self._groups[group])
        return recv.to(x.device)

    def barrier(self) -> None:
        if self.size > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    # -- autograd-aware collectives -----------------------------------------

    def sum(self, x: torch.Tensor, group: str = "world") -> torch.Tensor:
        """Σ over `group`; its backward sums the gradients over it."""
        if self.group_size(group) == 1:
            return x
        return _AllReduce.apply(x, self, group)

    def mean(self, x: torch.Tensor, group: str = "world") -> torch.Tensor:
        """The mean over `group` (`sum` / its size)."""
        n = self.group_size(group)
        return x if n == 1 else self.sum(x, group) / n

    def gather(self, x: torch.Tensor, group: str = "model") -> torch.Tensor:
        """[n, *x.shape] over `group`; its backward gives each rank the sum
        over the group of the gradients of its own slice."""
        if self.group_size(group) == 1:
            return x[None]
        return _AllGather.apply(x, self, group)

    def permute(self, x: torch.Tensor, shift: int = 1, group: str = "model") -> torch.Tensor:
        """The ring permute of `pp.py` (lax.ppermute i → i+shift); its
        backward rotates the gradient the other way."""
        if self.group_size(group) == 1:
            return x
        return _RingPermute.apply(x, self, group, shift)

    # -- the data-parallel step ---------------------------------------------

    def loss_denominator(self, count: torch.Tensor) -> torch.Tensor:
        """The denominator of a mean over a data-dependent count: this
        rank's local sum over it gives the global mean when the ranks'
        losses are averaged. max(Σ_data count, 1) / data; one process:
        max(count, 1)."""
        if self.size == 1:
            return torch.clamp(count, min=1)
        total = self.all_reduce(count.float()) / self.shape[MODEL_AXIS]
        return torch.clamp(total, min=1) / self.shape[DATA_AXIS]

    @torch.no_grad()
    def reduce_gradients(self, grads: Sequence[torch.Tensor],
                         stage_local: Sequence[bool]) -> None:
        """In place: replicated gradients summed over the world, stage-local
        ones (a pipeline stage's blocks) over the data group, all divided
        by the world size. Each kind goes in one flat all-reduce."""
        if self.size == 1:
            return
        for local, group in ((False, "world"), (True, "data")):
            gs = [g for g, s in zip(grads, stage_local) if s == local]
            if not gs:
                continue
            flat = torch.cat([g.reshape(-1).float() for g in gs])
            flat = self.all_reduce(flat, group) / self.size
            offset = 0
            for g in gs:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def grad_norm_sq(self, grads: Sequence[torch.Tensor],
                     stage_local: Sequence[bool]) -> torch.Tensor:
        """Σ g² over the model: replicated parameters counted once, the
        stage-local squares summed over the model group."""
        zero = torch.zeros((), device=self.device)
        rep = sum(((g.float() * g.float()).sum() for g, s in zip(grads, stage_local) if not s),
                  zero)
        loc = sum(((g.float() * g.float()).sum() for g, s in zip(grads, stage_local) if s),
                  zero)
        if any(stage_local):
            loc = self.all_reduce(loc, "model")
        return rep + loc

    @torch.no_grad()
    def mean_metrics(self, metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each metric averaged over the world, in one all-reduce."""
        if self.size == 1 or not metrics:
            return dict(metrics)
        keys = list(metrics)
        flat = [metrics[k].detach().float().reshape(-1) for k in keys]
        sizes = [t.numel() for t in flat]
        avg = self.all_reduce(torch.cat(flat).to(self.device)) / self.size
        out, off = {}, 0
        for k, n in zip(keys, sizes):
            out[k] = avg[off:off + n].reshape(metrics[k].shape)
            off += n
        return out

    def sum_host(self, values: Sequence[float]) -> List[float]:
        """Python floats summed over the world (float64, on the mesh's
        device: NCCL carries no CPU tensor)."""
        if self.size == 1:
            return list(values)
        t = torch.tensor(list(values), dtype=torch.float64, device=self.device)
        return self.all_reduce(t).cpu().tolist()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, group: str):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, group: str):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        mesh, group = ctx.mesh, ctx.group
        return mesh.all_reduce(g.contiguous(), group)[mesh.group_index(group)], None, None


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, group: str, shift: int):
        ctx.mesh, ctx.group, ctx.shift = mesh, group, shift
        return mesh.ring_shift(x, shift, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.ring_shift(g.contiguous(), -ctx.shift, ctx.group), None, None, None


_ACTIVE: Optional[Mesh] = None


def make_mesh(spec: MeshSpec = MeshSpec(), device=None) -> Mesh:
    """The mesh over the world `init_world` joined (this process alone
    when it was not called), checked as the JAX package checks its device
    count; it becomes the process's active mesh (`active_mesh`), which
    the loss reductions and the trainer read. `device`: this rank's device
    (init_world's; default cuda, or cuda:<rank> under NCCL)."""
    global _ACTIVE
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = spec.model if spec.model > 0 else 1
    data = spec.data if spec.data > 0 else max(1, n // model)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device is None:
        device = torch.device("cuda")
        if dist.is_initialized() and dist.get_backend() == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
    _ACTIVE = Mesh(data, model, torch.device(device))
    return _ACTIVE


def active_mesh() -> Optional[Mesh]:
    """The mesh make_mesh made last in this process (None before)."""
    return _ACTIVE


def clear_mesh() -> None:
    """Forget the active mesh and leave the process group (end of a run)."""
    global _ACTIVE
    _ACTIVE = None
    if dist.is_initialized():
        dist.destroy_process_group()


def loss_denominator(count: torch.Tensor) -> torch.Tensor:
    """`Mesh.loss_denominator` of the active mesh; max(count, 1) without one."""
    mesh = _ACTIVE
    if mesh is None or mesh.size == 1:
        return torch.clamp(count, min=1)
    return mesh.loss_denominator(count)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """x averaged over the active mesh's world (autograd-aware; x itself
    without one): the global mean of a per-rank mean over equal batches."""
    mesh = _ACTIVE
    return x if mesh is None or mesh.size == 1 else mesh.mean(x)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def named_stage_local(named: Iterable[Tuple[str, torch.Tensor]],
                      stage_names: Iterable[str]) -> List[bool]:
    keep = set(stage_names)
    return [n in keep for n, _ in named]
