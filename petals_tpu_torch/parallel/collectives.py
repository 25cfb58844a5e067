"""The one collective of the port's tensor parallelism: the sum of the
shards' partial outputs after a row-split projection (the psum XLA inserts
under the JAX package's ("tp",) mesh).

``reduce_shards`` adds the partials on shard 0's device in rank order and
copies the sum back to each shard's device. ``Tensor.to`` is a no-op where
the devices coincide and is differentiable, so autograd carries the
gradient back through the reduction with no custom Function. Each call with
more than one partial adds one to ``REDUCTIONS`` (a block of llama reduces
twice a step: after the attention output projection and after the MLP's
down projection)."""

from __future__ import annotations

from typing import List, Sequence

import torch

REDUCTIONS = [0]  # reductions across shards since the last reset


def reduce_shards(partials: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of ``partials`` (one a shard, the same shape), as one tensor
    on each partial's device: index i is on partial i's device. One partial
    is returned as it is."""
    if len(partials) == 1:
        return [partials[0]]
    REDUCTIONS[0] += 1
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in partials]


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
