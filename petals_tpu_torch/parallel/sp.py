"""Sequence parallelism over a tp x sp grid of devices in one process (the
port of the "sp" axis of petals_tpu's ``serving_mesh``).

The parameters are replicated over sp: ``GridParams`` holds one block as
``ranks[r]``, sp rank r's list of tp shard dicts, the very dicts of rank 0
where a shard's device is the same (one copy a distinct device: on one
card, sp ranks hold one set of weights). The dense KV cache is replicated
too (``ShardedCache`` with ranks, parallel/tp.py).

A block call splits its chunk's rows over the ranks (``seq_ranks``): rank r
takes rows [r * rows, (r + 1) * rows), runs the tp shards on them, and the
ranks meet only in attention (ops/attention.py ``attend_maybe_ring``): a ring
of K/V blocks on the stateless path, each rank's queries against the
replicated cache on the cached path. A chunk that does not split (a decode
step, an indivisible length) runs on rank 0 alone, and its K/V rows are
written into every rank's copy. One rank is the tp-only block, and one
rank of one shard the unsharded block.

Across processes (parallel/multihost.py) ``GridParams`` holds this
process's entries of the global grid only and carries their
``GroupLayout`` (parallel/collectives.py): ``block_sizes`` gives the
global tp and sp sizes and the global index of each local shard,
``rank_rows`` this process's ranks' rows, ``join_rows`` gathers every
process's rows, and attention meets the other processes' ranks
(``attend_maybe_ring``: a ring step between processes, or a gather of the
chunk's K/V rows on the cached path). A chunk that does not split runs on
every process's first rank alike.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from petals_tpu_torch.ops.attention import attend_maybe_ring
from petals_tpu_torch.ops.quant import QuantizedLinear
from petals_tpu_torch.parallel.collectives import gather_rows, grid_layout
from petals_tpu_torch.parallel.tp import ShardedCache, is_sharded


class GridParams:
    """One block's parameters over a tp x sp grid: ``ranks[r][t]`` is tp
    shard t's dict on sp rank r's device for that shard. Across processes
    ``layout`` (a ``GroupLayout``) places these entries in the global grid."""

    def __init__(self, ranks: Sequence[Sequence[dict]], layout=None):
        self.ranks = [list(r) for r in ranks]
        self.layout = layout

    def distinct(self) -> List[dict]:
        """Every distinct shard dict, once each."""
        seen = {}
        for r in self.ranks:
            for p in r:
                seen.setdefault(id(p), p)
        return list(seen.values())


def _moved(leaf, device: torch.device):
    if isinstance(leaf, QuantizedLinear):
        return QuantizedLinear(leaf.kind, leaf.data.to(device), leaf.scales.to(device), leaf.in_features,
                               leaf.out_features)
    return leaf.to(device)


def replicate_over_sp(shards: Sequence[dict], devices: Sequence[torch.device], num_sp: int) -> GridParams:
    """One block's tp shard dicts (on rank 0's devices) replicated over the
    ``num_sp`` ranks of the grid ``devices`` (``serving_devices``' order:
    entry t * num_sp + r is shard t of rank r). A shard whose rank-r device
    is rank 0's keeps rank 0's dict; elsewhere its leaves are copied there."""
    devices = [torch.device(d) for d in devices]
    ranks = []
    for r in range(num_sp):
        row = []
        for t, p in enumerate(shards):
            dev, home = devices[t * num_sp + r], devices[t * num_sp]
            row.append(p if dev == home else {name: _moved(leaf, dev) for name, leaf in p.items()})
        ranks.append(row)
    return GridParams(ranks)


def map_shards(params, fn):
    """``params`` (a dict, a list of tp shard dicts or ``GridParams``) with
    ``fn(shard_dict, t)`` applied to each distinct shard dict (t: its global
    tp rank), once each, the structure, its sharing and its layout kept."""
    if isinstance(params, GridParams):
        t0 = params.layout.t0 if params.layout is not None else 0
        done = {}
        for r in params.ranks:
            for t, p in enumerate(r):
                if id(p) not in done:
                    done[id(p)] = fn(p, t0 + t)
        return GridParams([[done[id(p)] for p in r] for r in params.ranks], params.layout)
    if is_sharded(params):
        return [fn(p, t) for t, p in enumerate(params)]
    return fn(params, 0)


def block_grid(params, kv) -> tuple:
    """(ranks, rank_kv) of one block's call: ``ranks[r]`` is sp rank r's list
    of tp shard dicts, ``rank_kv[r]`` that rank's caches, a (k, v) pair a
    shard, or None on the stateless path (no cache). A dict and a (k, v)
    pair are one rank of one shard; a list of shard dicts goes with a pair
    of ``ShardedCache`` or a list of (k, v) pairs. A cache of fewer ranks
    than the parameters (the tp-only scratch buffer of a forward that does
    not split) runs that many ranks."""
    if isinstance(params, GridParams):
        ranks = params.ranks
    elif is_sharded(params):
        ranks = [list(params)]
    else:
        ranks = [[params]]
    if kv is None:
        return ranks, None
    if isinstance(kv, list):
        rank_kv = [kv]
    else:
        k, v = kv
        if isinstance(k, ShardedCache):
            rank_kv = [list(zip(kr, vr)) for kr, vr in zip(k.ranks, v.ranks)]
        else:
            rank_kv = [[(k, v)]]
    return ranks[: len(rank_kv)], rank_kv


def block_sizes(params, grid, kv) -> tuple:
    """(n_tp, shard_ts, n_sp) of one block's call: the global tp size, the
    global tp index of each of ``grid``'s local shards (``block_grid``'s
    ranks), and how many sp ranks the call may split over: the global sp
    on the stateless path, the ranks its cache is replicated over on the
    cached path (one for the tp-only scratch buffer)."""
    lay = grid_layout(params)
    if lay is None:
        return len(grid[0]), range(len(grid[0])), len(grid)
    n_sp = lay.sp if kv is None else (getattr(kv[0], "n_sp", None) or 1)
    return lay.tp, range(lay.t0, lay.t0 + lay.n_t), n_sp


def seq_ranks(n_ranks: int, seq: int, kv, position, n_valid) -> int:
    """How many ranks split a chunk of ``seq`` rows (petals_tpu's
    ``attend_maybe_ring`` preconditions): on the stateless path (``kv``
    None) every rank, the ring, which needs position 0, no padded rows
    (``n_valid`` None) and ``seq`` a multiple of the ranks; on the cached
    path every rank when ``seq`` > 1 divides (a padded chunk too: its
    ``n_valid`` masks the padding), else rank 0 alone (decode steps and
    indivisible chunks: the tp-only path)."""
    if n_ranks == 1:
        return 1
    if kv is None:
        if n_valid is not None or not isinstance(position, int) or position != 0:
            raise ValueError(
                "ring attention serves the stateless full-sequence path: "
                "position must be literal 0 and n_valid None (no padded chunks)"
            )
        if seq % n_ranks:
            raise ValueError(f"ring attention needs the sequence ({seq}) to divide over {n_ranks} sp ranks")
        return n_ranks
    return n_ranks if seq > 1 and seq % n_ranks == 0 else 1


def _split_over(layout, n: int) -> bool:
    """Whether a chunk split over ``n`` ranks crosses processes."""
    return layout is not None and n > 1 and layout.sp_group is not None


def rank_rows(hidden: torch.Tensor, n: int, layout=None) -> List[torch.Tensor]:
    """``hidden`` [batch, seq, ...]'s rows cut into ``n`` equal parts, in
    rank order (views); across processes this process's ranks' parts."""
    rows = hidden.shape[1] // n
    ranks = range(layout.s0, layout.s0 + layout.n_s) if _split_over(layout, n) else range(n)
    return [hidden.narrow(1, r * rows, rows) for r in ranks]


def join_rows(parts: Sequence[torch.Tensor], n: int = 1, layout=None) -> torch.Tensor:
    """The ranks' row parts as one [batch, seq, ...] tensor on rank 0's
    device (one part is returned as it is); a chunk split over ``n`` ranks
    across processes gathers every process's rows."""
    out = parts[0] if len(parts) == 1 else torch.cat([p.to(parts[0].device) for p in parts], dim=1)
    return gather_rows(out, layout) if _split_over(layout, n) else out


def rank_n_valid(n_valid, r: int, rows: int):
    """The real rows of rank r's part of a chunk padded to ``n`` x ``rows``
    rows of which ``n_valid`` are real (None: all of them): an int, or a
    0-dim tensor where ``n_valid`` is one."""
    if n_valid is None:
        return None
    if isinstance(n_valid, torch.Tensor):
        return (n_valid - r * rows).clamp(0, rows)
    return min(max(int(n_valid) - r * rows, 0), rows)


def attend_shards(qkv, grid_kv, position, n_valid, use_flash, sliding_window, slopes=None, *, n_ranks: int = 1,
                  layout=None):
    """Attention of each tp shard's heads across the computing ranks:
    ``qkv[r][t]`` is rank r's (q, k, v) on shard t, ``grid_kv`` the ranks'
    caches (None: stateless), ``slopes`` each shard's ALiBi slopes. Under a
    layout whose sp ranks span processes, a chunk split over ``n_ranks``
    meets the other processes' ranks. Returns (``out[r][t]``, each shard's
    rank-0 (k_all, v_all) or None)."""
    cross = layout if _split_over(layout, n_ranks) else None
    n_ranks, n = len(qkv), len(qkv[0])
    out = [[None] * n for _ in range(n_ranks)]
    kv_out = []
    for t in range(n):
        q, k, v = ([qkv[r][t][i] for r in range(n_ranks)] for i in range(3))
        res, k_v = attend_maybe_ring(
            q, k, v, kv=None if grid_kv is None else [ranks[t] for ranks in grid_kv], position=position,
            n_valid=n_valid, use_flash=use_flash, sliding_window=sliding_window,
            alibi_slopes=None if slopes is None else slopes[t], layout=cross,
        )
        for r in range(n_ranks):
            out[r][t] = res[r]
        kv_out.append(k_v)
    return out, kv_out


__all__ = ["GridParams", "replicate_over_sp", "map_shards", "block_grid", "block_sizes", "seq_ranks", "rank_rows",
           "join_rows", "rank_n_valid", "attend_shards"]
