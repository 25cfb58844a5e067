"""Paged KV cache plumbing: page pools, block tables, in-place row scatters,
the quantized pool and its codec, and the plain versions of the
paged-attention kernels.

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

Quantized pools (``--kv_quant_type int8|nf4a``): a pool may instead be a
``PagedPool``, per-row codes plus a sibling float32 absmax scale per (token
row, kv head). Every write encodes its rows on the way in and every read
decodes them (the CUDA kernels in their registers, ``gather_pages`` here), so
the pool never holds floating-point rows. int8 stores one byte per element;
nf4a packs two 4-bit codes of the cubic NF4A map (ops/quant.py) per byte in
SPLIT-HALF order: byte j holds dim j in its low nibble and dim j + d/2 in its
high nibble. A zero scale decodes to exact zeros, so holes and never-written
rows read as zeros. The codes are byte-identical to the JAX package's jitted
encoder, which is what a JAX server's pool holds.

Not ported yet, and what each waits for:

- ``quantize_kv_rows_np`` / ``dequantize_kv_np``, the numpy codec twins:
  host-side migration packing and swap entries (swap and preemption,
  KV import/export and migration).
- ``scatter_lane_chunk_rows``: the speculative-verify write shape
  (speculative decoding).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from petals_tpu_torch.ops.attention import attend_reference
from petals_tpu_torch.ops.quant import NF4A_A, NF4A_B, NF4A_CODE

KV_QUANT_KINDS = ("none", "int8", "nf4a")

# XLA turns the jitted encoder's division by the constant 127 into a
# multiplication by its float32 reciprocal: these are a JAX server's bits
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))
# nf4a codes count the midpoints between neighbouring code values that a
# normalised value exceeds (float32, as the JAX package computes them)
_NF4A_MIDPOINTS = (NF4A_CODE[:-1] + NF4A_CODE[1:]) / 2.0
_MIDPOINTS_ON: dict = {}  # device -> the midpoints as a tensor there


class PagedPool(NamedTuple):
    """A quantized page pool: per-row codes plus their absmax scales.

    ``codes`` is int8 ``[..., n_pages, page_size, hkv, d]`` (kind "int8") or
    uint8 ``[..., n_pages, page_size, hkv, d // 2]`` with two split-half
    codes per byte (kind "nf4a"); ``scales`` is float32 ``[..., n_pages,
    page_size, hkv]``. ``shape`` and ``dtype`` answer the LOGICAL
    (dequantized) geometry and a bfloat16 type, so code that reads a pool's
    shape or dtype never sees the storage int type. Being a tuple,
    ``pool[i]`` is a field: take block i with ``pool_block``."""

    codes: torch.Tensor
    scales: torch.Tensor

    @property
    def kind(self) -> str:
        return "int8" if self.codes.dtype == torch.int8 else "nf4a"

    @property
    def shape(self) -> Tuple[int, ...]:
        """Logical (dequantized) shape: the packed nf4a byte axis doubles."""
        d = self.codes.shape[-1] * (2 if self.codes.dtype == torch.uint8 else 1)
        return (*self.codes.shape[:-1], d)

    @property
    def dtype(self) -> torch.dtype:
        """Logical dtype: rows dequantize to bfloat16."""
        return torch.bfloat16

    @property
    def nbytes(self) -> int:
        """Stored (wire) bytes of codes and scales."""
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())


#: a pool operand: the plain floating-point tensor or its quantized stand-in
PoolLike = Union[torch.Tensor, PagedPool]


def kv_quant_kind_of(pool) -> str:
    """"none" for a plain tensor pool, else the PagedPool's quant kind."""
    return pool.kind if isinstance(pool, PagedPool) else "none"


def kv_wire_bytes_per_token(hkv: int, d: int, kind: str, fp_itemsize: int = 2) -> int:
    """Stored bytes per token row for ONE side (k or v) of ONE block."""
    if kind == "int8":
        return hkv * (d + 4)  # 1 byte an element + a float32 scale per (row, head)
    if kind == "nf4a":
        return hkv * (d // 2 + 4)  # packed nibbles + a float32 scale
    return hkv * d * fp_itemsize


def pool_block(pool: PoolLike, i: int) -> PoolLike:
    """Block ``i`` of a span-stacked pool [n_blocks, n_pages, ...]."""
    if isinstance(pool, PagedPool):
        return PagedPool(pool.codes[i], pool.scales[i])
    return pool[i]


# --------------------------------------------------------------- quant codec


def quantize_kv_rows(rows: torch.Tensor, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode rows ``[..., d]`` -> ``(codes [..., d_store], scales [...])``
    with a per-row absmax scale over the last (head-dim) axis.

    int8: symmetric, ``scale = absmax * f32(1/127)``. nf4a: the stored scale
    IS the absmax; each normalised value's code is the count of NF4A
    midpoints it exceeds, one ``bucketize`` where the JAX package adds 15
    comparisons, then split-half packed (byte j = dim j | dim (j + d/2) << 4)."""
    if kind not in ("int8", "nf4a"):
        raise ValueError(f"kv quant kind must be int8|nf4a, got {kind!r}")
    rows_f = rows.float()
    absmax = rows_f.abs().amax(dim=-1)
    if kind == "int8":
        scale = absmax.clamp_min(1e-8) * _RECIP_127
        codes = torch.round(rows_f / scale[..., None]).clamp_(-127, 127)
        return codes.to(torch.int8), scale
    normed = rows_f / absmax.clamp_min(1e-8)[..., None]
    midpoints = _MIDPOINTS_ON.get(rows.device)
    if midpoints is None:
        midpoints = _MIDPOINTS_ON.setdefault(rows.device, torch.from_numpy(_NF4A_MIDPOINTS).to(rows.device))
    # right=False: the index is the count of midpoints strictly below the value
    codes = torch.bucketize(normed, midpoints, out_int32=True).to(torch.uint8)
    half = rows.shape[-1] // 2
    return codes[..., :half] | (codes[..., half:] << 4), absmax


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor, kind: str,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Decode ``(codes [..., d_store], scales [...])`` back to rows ``[..., d]``.
    nf4a decodes arithmetically, ``v = scale * (A*dl + B*dl**3)`` with
    ``dl = code - 7.5``, and un-packs the split halves by concatenation along
    the head dim. A ZERO scale decodes every element to exactly 0.0."""
    sf = scales[..., None].float()
    if kind == "int8":
        return (codes.float() * sf).to(dtype)
    if kind != "nf4a":
        raise ValueError(f"kv quant kind must be int8|nf4a, got {kind!r}")
    c = codes.to(torch.int32)

    def poly(p):
        dl = p.float() - 7.5
        return dl * (NF4A_A + NF4A_B * dl * dl)

    vals = torch.cat([poly(c & 0x0F), poly((c >> 4) & 0x0F)], dim=-1)
    return (vals * sf).to(dtype)


class PagedKV(NamedTuple):
    """One side (k or v) of a block's paged cache: the shared page pool plus
    the per-lane block tables. Rides through ``block_apply`` in place of the
    dense KV buffer; ``update_kv_cache`` and ``attend`` recognise it."""

    pool: PoolLike  # [n_pages, page_size, hkv, d] tensor, or a PagedPool
    tables: torch.Tensor  # [n_lanes, max_pages] int32; -1 = unallocated

    @property
    def max_length(self) -> int:
        return self.tables.shape[1] * self.pool.shape[1]

    @property
    def shape(self) -> Tuple[int, ...]:
        """Dense-equivalent shape [n_lanes, max_length, hkv, d]."""
        return (self.tables.shape[0], self.max_length, *self.pool.shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.pool.dtype


def max_pages_for(max_length: int, page_size: int) -> int:
    """Table slots per lane: max_length rounded UP to whole pages."""
    return -(-int(max_length) // int(page_size))


def identity_tables(n_lanes: int, max_pages: int) -> np.ndarray:
    """The contiguous layout: lane i owns pages [i*max_pages, (i+1)*max_pages)."""
    return np.arange(n_lanes * max_pages, dtype=np.int32).reshape(n_lanes, max_pages)


def _gather_pages_arr(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """gather_pages over ONE tensor of any trailing rank (a value pool, a
    codes pool, a scales pool)."""
    n_pages, page_size = pool.shape[0], pool.shape[1]
    n_lanes, max_pages = tables.shape
    flat = tables.reshape(-1).long()
    pages = pool[flat.clamp(0, n_pages - 1)]  # [n_lanes*max_pages, ps, hkv, d]
    hole = (flat < 0).reshape(-1, *([1] * (pool.dim() - 1)))
    pages = pages.masked_fill(hole, 0)
    return pages.reshape(n_lanes, max_pages * page_size, *pool.shape[2:])


def gather_pages(pool: PoolLike, tables: torch.Tensor) -> torch.Tensor:
    """Dense per-lane view of one block's pool: [n_lanes, max_pages *
    page_size, hkv, d]. Unallocated slots read as ZEROS, never as another
    tenant's page. A ``PagedPool`` gathers codes AND scales (holes zero
    both) and returns the dequantized bfloat16 view."""
    if isinstance(pool, PagedPool):
        codes = _gather_pages_arr(pool.codes, tables)
        scales = _gather_pages_arr(pool.scales, tables)
        return dequantize_kv(codes, scales, pool.kind, pool.dtype)
    return _gather_pages_arr(pool, tables)


def _write_pairs(pools, rows):
    """The (stored tensor, rows) pairs that write ``rows[i]`` into
    ``pools[i]``: a plain pool takes its rows as they are; quantized pools
    take codes and scales, all sides encoded in ONE call (the encoding is
    per row, so stacking the sides changes no byte)."""
    if not isinstance(pools[0], PagedPool):
        return list(zip(pools, rows))
    codes, scales = quantize_kv_rows(torch.stack(rows), pools[0].kind)
    pairs = []
    for i, pool in enumerate(pools):
        pairs += [(pool.codes, codes[i]), (pool.scales, scales[i])]
    return pairs


def _drop_scatter_(pairs, flat_idx: torch.Tensor) -> None:
    """For each (pool [n_pages, ps, ...], rows [n, ...]) in ``pairs``, write
    the rows at flat (page * ps + slot) indices IN PLACE; an index outside
    the pool drops. The index work is shared by the pairs (k and v, or the
    codes and scales of both).

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
    pool: PoolLike, rows: torch.Tensor, tables: torch.Tensor, positions: torch.Tensor
) -> None:
    """Write each lane's new token row into its page, in place (encoded on
    the way in for a PagedPool). rows [n_lanes, hkv, d]; positions [n_lanes]
    (idle sentinel = max_length)."""
    _drop_scatter_(_write_pairs([pool], [rows]), token_rows_index(pool, tables, positions))


def scatter_chunk_rows(
    pool: PoolLike, rows: torch.Tensor, table_row: torch.Tensor, positions: torch.Tensor
) -> None:
    """Write a prefill chunk's rows into ONE lane's pages, in place (encoded
    on the way in for a PagedPool). rows [chunk, hkv, d]; table_row
    [max_pages]; positions [chunk] (padded rows carry a sentinel >=
    max_length and drop)."""
    _drop_scatter_(_write_pairs([pool], [rows]), chunk_rows_index(pool, table_row, positions))


def scatter_lane_pages(pool: PoolLike, lane_pages: torch.Tensor, table_row) -> None:
    """Write a whole lane-shaped buffer back into its pages, IN PLACE (the
    exclusive-op check-in of a lane that was gathered out, computed on and is
    handed back). pool [..., n_pages, ps, hkv, d] (one block's, or the
    span-stacked pool), lane_pages [..., max_pages, ps, hkv, d] with the same
    leading dims; table_row [max_pages], a host array or a tensor (read on
    the host: the check-in is not on the per-token path). Unallocated slots
    (-1) drop. On a quantized pool the buffer is RE-ENCODED row by row; rows
    the exclusive op did not touch round-trip within one quantization."""
    if isinstance(table_row, torch.Tensor):
        table_row = table_row.cpu().numpy()
    row = np.asarray(table_row)
    slots = np.nonzero(row >= 0)[0]
    if slots.size == 0:
        return
    page_axis = len(pool.shape) - 4  # of the logical [..., n_pages, ps, hkv, d]
    device = lane_pages.device
    slots_t = torch.as_tensor(slots, dtype=torch.long, device=device)
    pages_t = torch.as_tensor(row[slots], dtype=torch.long, device=device)
    kept = lane_pages.index_select(page_axis, slots_t)
    if isinstance(pool, PagedPool):
        codes, scales = quantize_kv_rows(kept, pool.kind)
        pool.codes.index_copy_(page_axis, pages_t, codes.to(pool.codes.dtype))
        pool.scales.index_copy_(page_axis, pages_t, scales.to(pool.scales.dtype))
    else:
        pool.index_copy_(page_axis, pages_t, kept.to(pool.dtype))


def paged_update_kv(k_kv: PagedKV, v_kv: PagedKV, k_new, v_new, position, n_valid=None):
    """The PagedKV arm of ``models/common.py update_kv_cache``: scatter the new
    rows into the pools IN PLACE (encoded on the way in when the pools are
    ``PagedPool``s) and return (k_kv, v_kv, kv_length).

    - decode: ``position`` is a [n_lanes] tensor and k_new/v_new are
      [n_lanes, 1, hkv, d] (sentinel positions drop);
    - chunked prefill: ``position`` is a scalar and k_new/v_new are
      [1, chunk, hkv, d] with ``n_valid`` real rows; the lane's table row is
      ``tables[0]``. ``position`` and ``n_valid`` are host integers or 0-dim
      integer tensors on the rows' device (a captured step's chunk scalars);
      both give the same bytes, and kv_length comes back in the same form.
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
        _drop_scatter_(_write_pairs([k_kv.pool, v_kv.pool], [k_new[:, 0], v_new[:, 0]]), idx)
        return k_kv, v_kv, position + 1
    if k_new.shape[0] != 1 or tables.shape[0] != 1:
        raise ValueError(
            "scalar-position paged writes are single-lane chunks: "
            f"got batch={k_new.shape[0]}, table rows={tables.shape[0]}"
        )
    seq = k_new.shape[1]
    n = seq if n_valid is None else n_valid
    pos = position
    offs = torch.arange(seq, device=k_new.device)
    # padded tail rows route to the sentinel one past the lane and drop
    write_pos = torch.where(offs < n, pos + offs, k_kv.max_length)
    idx = chunk_rows_index(k_kv.pool, tables[0], write_pos)
    _drop_scatter_(_write_pairs([k_kv.pool, v_kv.pool], [k_new[0], v_new[0]]), idx)
    return k_kv, v_kv, pos + n


def slot_valid(pool: PoolLike, tables: torch.Tensor) -> torch.Tensor:
    """[n_lanes, max_pages * page_size] bool: the slots whose page lies in
    the pool. A hole (-1) is no position at all, not a zero row: the kernels
    skip its page, as the TPU kernels do, so the plain versions mask it out
    of the softmax (a zero K row would score 0 and take a share of it)."""
    n_pages, page_size = pool.shape[0], pool.shape[1]
    return ((tables >= 0) & (tables < n_pages)).repeat_interleave(page_size, dim=1)


def paged_attend(
    q: torch.Tensor,
    k_pool: PoolLike,
    v_pool: PoolLike,
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
    max_pages]; positions [n_lanes] int32. On ``PagedPool``s it is the plain
    version of the quantized arm too: pages dequantize to bfloat16 first.
    Holes are seen by no query (``slot_valid``)."""
    k = gather_pages(k_pool, tables)
    v = gather_pages(v_pool, tables)
    return attend_reference(
        q, k, v, q_offset=positions, kv_length=positions + q.shape[1],
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        kv_valid=slot_valid(k_pool, tables),
    )


def paged_prefill_attend(
    q: torch.Tensor,
    k_pool: PoolLike,
    v_pool: PoolLike,
    table_row: torch.Tensor,
    chunk_pos,
    n_valid,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the paged CHUNKED-PREFILL kernel: causal attention for
    one lane's chunk q [1, chunk, hq, d] starting at absolute position
    ``chunk_pos``, whose ``n_valid`` real rows' KV is already in the pages.
    ``chunk_pos`` and ``n_valid`` are host integers or 0-dim integer tensors
    on q's device, with identical results. Rows past n_valid give finite
    values that no caller reads; holes are seen by no query (``slot_valid``).
    Takes ``PagedPool``s as ``paged_attend`` does."""
    k = gather_pages(k_pool, table_row[None])
    v = gather_pages(v_pool, table_row[None])
    return attend_reference(
        q, k, v, q_offset=chunk_pos, kv_length=chunk_pos + n_valid,
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        kv_valid=slot_valid(k_pool, table_row[None]),
    )
