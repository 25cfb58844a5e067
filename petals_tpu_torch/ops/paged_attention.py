"""Paged KV cache plumbing: page pools, block tables, in-place row scatters,
and the plain versions of the two paged-attention kernels.

Layout (per span block, as in petals_tpu/ops/paged_attention.py):

- page pool   [n_pages, page_size, kv_heads, head_dim], one for k, one for v;
- block table [n_lanes, max_pages] int32: the page of each (lane, slot), with
  ``-1`` for an unallocated slot; ``max_pages * page_size == max_length``.

Lanes attend with ``kv_length = position + 1``. Pool content is always finite
(zero-initialised, only ever written with computed rows).

Writes happen IN PLACE: where the JAX package scatters into a donated pool and
returns the new one, these functions mutate the pool tensor they are given.
A write whose position is the idle sentinel (``>= max_length``), whose slot is
unallocated, or that is a padded chunk row is dropped, as JAX drops it with
``mode="drop"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from petals_tpu_torch.ops.attention import attend_reference


class PagedKV(NamedTuple):
    """One side (k or v) of a block's paged cache: the shared page pool plus
    the per-lane block tables. Rides through ``block_apply`` in place of the
    dense KV buffer; ``update_kv_cache`` and ``attend`` recognise it."""

    pool: torch.Tensor  # [n_pages, page_size, hkv, d]
    tables: torch.Tensor  # [n_lanes, max_pages] int32; -1 = unallocated

    @property
    def max_length(self) -> int:
        return self.tables.shape[1] * self.pool.shape[1]


def max_pages_for(max_length: int, page_size: int) -> int:
    """Table slots per lane: max_length rounded UP to whole pages."""
    return -(-int(max_length) // int(page_size))


def identity_tables(n_lanes: int, max_pages: int) -> np.ndarray:
    """The contiguous layout: lane i owns pages [i*max_pages, (i+1)*max_pages)."""
    return np.arange(n_lanes * max_pages, dtype=np.int32).reshape(n_lanes, max_pages)


def gather_pages(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Dense per-lane view of one block's pool: [n_lanes, max_pages *
    page_size, hkv, d]. Unallocated slots read as ZEROS, never as another
    tenant's page."""
    n_pages, page_size = pool.shape[0], pool.shape[1]
    n_lanes, max_pages = tables.shape
    flat = tables.reshape(-1).long()
    pages = pool[flat.clamp(0, n_pages - 1)]  # [n_lanes*max_pages, ps, hkv, d]
    hole = (flat < 0).reshape(-1, *([1] * (pool.dim() - 1)))
    pages = pages.masked_fill(hole, 0)
    return pages.reshape(n_lanes, max_pages * page_size, *pool.shape[2:])


def _drop_scatter_(pairs, flat_idx: torch.Tensor) -> None:
    """For each (pool [n_pages, ps, hkv, d], rows [n, hkv, d]) in ``pairs``,
    write the rows at flat (page * ps + slot) indices IN PLACE; an index
    outside the pool drops. The index work is shared by the pairs (k and v).

    ``index_put_`` has no drop mode, and selecting the valid rows with a mask
    would make the host wait for the device. So a dropped write is redirected
    onto the first valid row's target, carrying that row's own value: two
    writes of identical bytes to one place, whatever their order. With no
    valid row at all, every write lands on flat row 0 with the bytes it
    already holds. Every index stays a tensor: no host sync."""
    n = flat_idx.shape[0]
    if n == 0:
        return
    pool = pairs[0][0]
    total = pool.shape[0] * pool.shape[1]
    valid = (flat_idx >= 0) & (flat_idx < total)
    first = valid.to(torch.uint8).argmax().view(1)  # first valid row (row 0 when none)
    any_valid = valid.index_select(0, first)
    target = torch.where(valid, flat_idx, torch.where(any_valid, flat_idx.index_select(0, first), 0))
    source = torch.where(valid, torch.arange(n, device=flat_idx.device), first)
    for pool, rows in pairs:
        flat = pool.view(total, *pool.shape[2:])
        values = rows.to(pool.dtype).index_select(0, source)
        keep = any_valid.view(1, *(1,) * (rows.dim() - 1))
        flat[target] = torch.where(keep, values, flat[:1])


def _flat_index(n_pages: int, page_size: int, page: torch.Tensor, positions: torch.Tensor,
                in_range: torch.Tensor) -> torch.Tensor:
    """page * page_size + slot for valid writes, one past the pool (dropped)
    for the rest."""
    valid = in_range & (page >= 0)
    return torch.where(valid, page * page_size + positions % page_size, n_pages * page_size)


def token_rows_index(pool: torch.Tensor, tables: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Flat write index of each lane's token at ``positions`` [n_lanes]
    (idle sentinel = max_length drops)."""
    n_pages, page_size = pool.shape[0], pool.shape[1]
    max_pages = tables.shape[1]
    positions = positions.long()
    slot = torch.div(positions, page_size, rounding_mode="floor")
    in_range = (positions >= 0) & (slot < max_pages)
    page = tables.gather(1, slot.clamp(0, max_pages - 1)[:, None])[:, 0].long()
    return _flat_index(n_pages, page_size, page, positions, in_range)


def chunk_rows_index(pool: torch.Tensor, table_row: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Flat write index of a chunk's rows at ``positions`` [chunk] in ONE
    lane (padded rows carry a sentinel >= max_length and drop)."""
    n_pages, page_size = pool.shape[0], pool.shape[1]
    max_pages = table_row.shape[0]
    positions = positions.long()
    slot = torch.div(positions, page_size, rounding_mode="floor")
    in_range = (positions >= 0) & (slot < max_pages)
    page = table_row.long()[slot.clamp(0, max_pages - 1)]
    return _flat_index(n_pages, page_size, page, positions, in_range)


def scatter_token_rows(
    pool: torch.Tensor, rows: torch.Tensor, tables: torch.Tensor, positions: torch.Tensor
) -> None:
    """Write each lane's new token row into its page, in place. rows
    [n_lanes, hkv, d]; positions [n_lanes] (idle sentinel = max_length)."""
    _drop_scatter_([(pool, rows)], token_rows_index(pool, tables, positions))


def scatter_chunk_rows(
    pool: torch.Tensor, rows: torch.Tensor, table_row: torch.Tensor, positions: torch.Tensor
) -> None:
    """Write a prefill chunk's rows into ONE lane's pages, in place. rows
    [chunk, hkv, d]; table_row [max_pages]; positions [chunk] (padded rows
    carry a sentinel >= max_length and drop)."""
    _drop_scatter_([(pool, rows)], chunk_rows_index(pool, table_row, positions))


def paged_update_kv(k_kv: PagedKV, v_kv: PagedKV, k_new, v_new, position, n_valid=None):
    """The PagedKV arm of ``models/common.py update_kv_cache``: scatter the new
    rows into the pools IN PLACE and return (k_kv, v_kv, kv_length).

    - decode: ``position`` is a [n_lanes] tensor and k_new/v_new are
      [n_lanes, 1, hkv, d] (sentinel positions drop);
    - chunked prefill: ``position`` is a scalar and k_new/v_new are
      [1, chunk, hkv, d] with ``n_valid`` real rows; the lane's table row is
      ``tables[0]``.
    """
    tables = k_kv.tables
    if isinstance(position, torch.Tensor) and position.dim() == 1:
        if n_valid is not None:
            raise ValueError(f"per-lane paged writes take no n_valid (got n_valid={n_valid})")
        if k_new.shape[1] != 1:
            raise ValueError(
                "per-lane paged writes of more than one row (speculative verify) "
                "are not supported by this port yet"
            )
        idx = token_rows_index(k_kv.pool, tables, position)
        _drop_scatter_([(k_kv.pool, k_new[:, 0]), (v_kv.pool, v_new[:, 0])], idx)
        return k_kv, v_kv, position + 1
    if k_new.shape[0] != 1 or tables.shape[0] != 1:
        raise ValueError(
            "scalar-position paged writes are single-lane chunks: "
            f"got batch={k_new.shape[0]}, table rows={tables.shape[0]}"
        )
    seq = k_new.shape[1]
    n = seq if n_valid is None else int(n_valid)
    pos = int(position)
    offs = torch.arange(seq, device=k_new.device)
    # padded tail rows route to the sentinel one past the lane and drop
    write_pos = torch.where(offs < n, pos + offs, k_kv.max_length)
    idx = chunk_rows_index(k_kv.pool, tables[0], write_pos)
    _drop_scatter_([(k_kv.pool, k_new[0]), (v_kv.pool, v_new[0])], idx)
    return k_kv, v_kv, pos + n


def paged_attend(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the paged DECODE kernel: gather each lane's pages into
    a dense view and attend with ragged lengths (kv_length = position + 1).
    q [n_lanes, 1, hq, d]; pools [n_pages, ps, hkv, d]; tables [n_lanes,
    max_pages]; positions [n_lanes] int32."""
    k = gather_pages(k_pool, tables)
    v = gather_pages(v_pool, tables)
    return attend_reference(
        q, k, v, q_offset=positions, kv_length=positions + q.shape[1],
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
    )


def paged_prefill_attend(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table_row: torch.Tensor,
    chunk_pos: int,
    n_valid: int,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the paged CHUNKED-PREFILL kernel: causal attention for
    one lane's chunk q [1, chunk, hq, d] starting at absolute position
    ``chunk_pos``, whose ``n_valid`` real rows' KV is already in the pages.
    Rows past n_valid give finite values that no caller reads."""
    k = gather_pages(k_pool, table_row[None])
    v = gather_pages(v_pool, table_row[None])
    return attend_reference(
        q, k, v, q_offset=int(chunk_pos), kv_length=int(chunk_pos) + int(n_valid),
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
    )
