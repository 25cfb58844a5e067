"""The collectives of the port's tensor and sequence parallelism.

In one process: the sum of the shards' partial outputs after a row-split
projection (the psum XLA inserts under the JAX package's ("tp",) mesh).
``reduce_shards`` adds the partials on shard 0's device in rank order and
copies the sum back to each shard's device. ``Tensor.to`` is a no-op where
the devices coincide and is differentiable, so autograd carries the
gradient back through the reduction with no custom Function. Each call with
more than one partial adds one to ``REDUCTIONS`` (a block of llama reduces
twice a step: after the attention output projection and after the MLP's
down projection).

Across processes (parallel/multihost.py): a ``GroupLayout`` says which
entries of the global tp x sp grid this process holds and over which
``torch.distributed`` groups it meets the others. ``reduce_shards`` then
sums the local partials in rank order and all-reduces the sum over the tp
group; autograd no longer crosses the process boundary by itself, so the
reductions are the Megatron pair of ``torch.autograd.Function``s: an
all-reduce whose backward is the identity (``_AllReduce``) at each exit of
the sharded region, and an identity whose backward all-reduces
(``enter_tp``) at each entry. The sequence-parallel collectives (a ring
step between processes, a gather of rows) live here too.

The data group's backend is NCCL where every process has a card of its
own, gloo otherwise (two processes on one card). A gloo collective that
does not take CUDA tensors (``GLOO_CUDA_NATIVE`` lists those that do) is
staged through host memory explicitly. ``CROSSINGS`` counts the
collectives on the data group, by kind.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

REDUCTIONS = [0]  # reductions across shards since the last reset
CROSSINGS = {"all_reduce": 0, "all_gather": 0, "ring": 0}  # data-group collectives since the last reset
# the gloo collectives that take CUDA tensors in place (torch 2.11 on the
# H100: all_reduce, all_gather and broadcast, bf16 too; send / recv refuse
# them, scripts/probe_gloo_cuda.py); the rest are staged through host memory
GLOO_CUDA_NATIVE = frozenset({"all_reduce", "all_gather"})


@dataclasses.dataclass
class GroupLayout:
    """This process's block of the global tp x sp grid (entry ``t * sp +
    s``: tp shard t of sp rank s) and the groups it meets the others over.
    It holds shards [t0, t0 + n_t) of sp ranks [s0, s0 + n_s). ``tp_group``
    spans the processes that hold the other shards of the same ranks (None
    when this process holds every shard), ``sp_group`` those that hold the
    other ranks of the same shards (None when it holds every rank);
    ``sp_prev`` / ``sp_next`` are the global ranks of its neighbours on the
    ring, ``sp_index`` / ``sp_procs`` its place among them, on
    ``data_group`` (every process); ``backend`` is the data group's ("nccl"
    or "gloo")."""

    tp: int
    sp: int
    t0: int
    n_t: int
    s0: int
    n_s: int
    backend: str = "gloo"
    tp_group: object = None
    sp_group: object = None
    sp_prev: int = 0
    sp_next: int = 0
    sp_index: int = 0
    sp_procs: int = 1
    data_group: object = None


def grid_layout(params) -> Optional[GroupLayout]:
    """The ``GroupLayout`` a block's parameters carry (``GridParams`` of a
    span across processes), None in one process."""
    return getattr(params, "layout", None)


def _staged(t: torch.Tensor, op: str, layout: GroupLayout) -> torch.Tensor:
    """``t`` as the data group takes it for ``op``: on the host where gloo
    does not take a CUDA tensor for it."""
    if layout.backend == "gloo" and t.device.type == "cuda" and op not in GLOO_CUDA_NATIVE:
        t = t.cpu()
    return t.contiguous()


def _all_reduce(t: torch.Tensor, group, layout: GroupLayout) -> torch.Tensor:
    import torch.distributed as dist

    CROSSINGS["all_reduce"] += 1
    buf = _staged(t, "all_reduce", layout)
    if buf is t:
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(device=t.device, dtype=t.dtype)


def _all_gather(t: torch.Tensor, group, layout: GroupLayout) -> List[torch.Tensor]:
    """Every process's ``t`` (one shape on all) over ``group``, in the
    group's rank order, each on ``t``'s device in its dtype."""
    import torch.distributed as dist

    CROSSINGS["all_gather"] += 1
    buf = _staged(t, "all_gather", layout)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return [p.to(device=t.device, dtype=t.dtype) for p in parts]


def _send_recv(t: torch.Tensor, to: int, frm: int, layout: GroupLayout) -> torch.Tensor:
    """Send ``t`` to global rank ``to`` and receive one of its shape from
    ``frm``, both at once (no ordering deadlock), on the data group."""
    import torch.distributed as dist

    CROSSINGS["ring"] += 1
    buf = _staged(t, "send", layout)
    out = torch.empty_like(buf)
    works = [dist.isend(buf, to, group=layout.data_group), dist.irecv(out, frm, group=layout.data_group)]
    for work in works:
        work.wait()
    return out.to(device=t.device, dtype=t.dtype)


class _AllReduce(torch.autograd.Function):
    """Sum over a group forward; the gradient of a replicated sum is the
    same on every process, so backward is the identity."""

    @staticmethod
    def forward(ctx, x, group, layout):
        return _all_reduce(x, group, layout)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterTP(torch.autograd.Function):
    """Identity forward; backward sums the shards' partial gradients of a
    replicated input over the tp group."""

    @staticmethod
    def forward(ctx, x, group, layout):
        ctx.group, ctx.layout = group, layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.layout), None, None


class _RingPass(torch.autograd.Function):
    """One ring step between processes: send to the next process on the
    ring, receive from the previous one; backward goes round the ring the
    other way."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return _send_recv(x, layout.sp_next, layout.sp_prev, layout)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.layout
        return _send_recv(g.contiguous(), lay.sp_prev, lay.sp_next, lay), None


class _GatherRows(torch.autograd.Function):
    """Every process's rows of a chunk joined along dim 1 in sp order;
    backward keeps this process's own rows of the gradient (the joined
    tensor is replicated, and each process's part of the work downstream
    reads its own rows)."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return torch.cat(_all_gather(x, layout.sp_group, layout), dim=1)

    @staticmethod
    def backward(ctx, g):
        return own_rows(g, ctx.layout).contiguous(), None


def reduce_shards(partials: Sequence[torch.Tensor], layout: Optional[GroupLayout] = None) -> List[torch.Tensor]:
    """The sum of ``partials`` (one a shard, the same shape), as one tensor
    on each partial's device: index i is on partial i's device. One partial
    is returned as it is. Under a ``layout`` whose shards span processes the
    local sum is all-reduced over the tp group."""
    cross = layout is not None and layout.tp_group is not None
    if len(partials) == 1 and not cross:
        return [partials[0]]
    REDUCTIONS[0] += 1
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    if cross:
        total = _AllReduce.apply(total, layout.tp_group, layout)
    return [total.to(p.device) for p in partials]


def enter_tp(x: torch.Tensor, layout: Optional[GroupLayout], n_shards: int) -> torch.Tensor:
    """``x``, a replicated input of one shard's part of the sharded region
    (a normed residual stream): itself unsharded; a view of it, one node a
    shard, in one process, so each shard's partial gradients sum before the
    shards' do, as across processes; and under a layout whose shards span
    processes the point where backward sums the shards' partial gradients."""
    if n_shards == 1:
        return x
    if layout is None or layout.tp_group is None:
        return x.view_as(x)
    return _EnterTP.apply(x, layout.tp_group, layout)


def ring_pass(x: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    return _RingPass.apply(x, layout)


def gather_rows(x: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    """Every sp process's rows of a chunk (``x``: this process's, dim 1)
    joined in sp order; differentiable."""
    return _GatherRows.apply(x, layout)


def own_rows(x: torch.Tensor, layout: GroupLayout) -> torch.Tensor:
    """This process's rows of a chunk whose dim 1 holds every sp process's
    rows in sp order (a view): the inverse of ``gather_rows``."""
    rows = x.shape[1] // layout.sp_procs
    return x.narrow(1, layout.sp_index * rows, rows)


def per_copy(fn, *columns) -> list:
    """``[fn(*args) for args in zip(*columns)]``, each distinct tuple of
    argument objects computed once: shards on one device hold one copy of
    a replicated value (``reduce_shards`` hands each the same sum), so the
    norms and residual adds around the reductions run once for them, and
    their backward sees one gradient instead of a sum of per-shard ones."""
    done = {}
    for args in zip(*columns):
        key = tuple(map(id, args))
        if key not in done:
            done[key] = fn(*args)
    return [done[tuple(map(id, args))] for args in zip(*columns)]


def reduction_count() -> int:
    return REDUCTIONS[0]


def reset_reduction_count() -> None:
    REDUCTIONS[0] = 0
    for k in CROSSINGS:
        CROSSINGS[k] = 0
