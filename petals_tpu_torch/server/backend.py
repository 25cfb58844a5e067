"""TransformerBackend: the compute engine for a span of blocks, paged
decode and mixed prefill+decode steps (the paged part of
petals_tpu/server/backend.py).

Where the JAX backend runs the span as one jitted ``lax.scan`` over stacked
parameters and donated pools, this one is a Python loop over blocks that
mutates the page pools IN PLACE. The pool layout stays [n_blocks, n_pages,
page_size, hkv, d]; ``pool[i]`` is block i's contiguous page pool. Attention
on a ``PagedKV`` goes to the CUDA paged-attention kernels for tensors on the
card and to their plain versions for tensors on the CPU
(ops/paged_flash_attention.py).

No jit means no shape buckets: a prefill chunk runs at its own length with
``n_valid`` equal to it, which gives the reply rows a padded bucket gives,
so nothing here pads (the JAX package's ``bucket_length`` has no use).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from petals_tpu_torch.models.registry import ModelFamily
from petals_tpu_torch.ops.paged_attention import PagedKV
from petals_tpu_torch.server.memory_cache import TensorDescriptor

logger = logging.getLogger(__name__)


def _as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype if dtype is not None else x.dtype)


class TransformerBackend:
    """Serves blocks [first_block, first_block + n_blocks) of one model."""

    def __init__(
        self,
        family: ModelFamily,
        cfg,
        params: Union[Dict[str, torch.Tensor], Sequence[Dict[str, torch.Tensor]]],
        *,
        first_block: int,
        n_blocks: int,
        device: torch.device,
        compute_dtype: torch.dtype = torch.bfloat16,
        max_chunk_size_bytes: int = 256 * 1024 * 1024,
    ):
        """``params`` is a list of per-block dicts, or one dict whose tensors
        are stacked along a leading block axis (utils/convert.py
        stacked_from_numpy); the stacked form is viewed per block. Hidden
        states and the KV pool are kept in ``compute_dtype``."""
        self.family = family
        self.cfg = cfg
        if isinstance(params, dict):
            params = [{name: t[i] for name, t in params.items()} for i in range(n_blocks)]
        if len(params) != n_blocks:
            raise ValueError(f"got parameters for {len(params)} blocks, expected {n_blocks}")
        self.block_params: List[Dict[str, torch.Tensor]] = list(params)
        self.first_block = first_block
        self.n_blocks = n_blocks
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.max_chunk_size_bytes = max_chunk_size_bytes
        self.num_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        self.hidden_size = cfg.hidden_size

    # ------------------------------------------------------------- cache descriptors

    def paged_cache_descriptors(self, n_pages: int, page_size: int, start: int, end: int):
        """(k, v) descriptors of the paged pool of blocks [start, end), each
        [n, n_pages, page_size, hkv, d] in compute_dtype on the backend's device."""
        shape = (end - start, n_pages, page_size, self.num_kv_heads, self.head_dim)
        return (
            TensorDescriptor(shape, self.compute_dtype, self.device),
            TensorDescriptor(shape, self.compute_dtype, self.device),
        )

    def cache_bytes_per_token(self) -> int:
        """KV bytes per token across the span."""
        return 2 * self.n_blocks * self.num_kv_heads * self.head_dim * self.compute_dtype.itemsize

    # ------------------------------------------------------------- steps

    @torch.no_grad()
    def paged_decode_step(self, hidden, pool_kv, positions, tables):
        """One coalesced decode step over a set of lanes, PAGED layout.

        Args:
          hidden: [n_lanes, 1, hidden] (idle lanes: any finite filler).
          pool_kv: (k, v) page pools [n_blocks, n_pages, page_size, hkv, d],
            updated IN PLACE.
          positions: int32 [n_lanes]; idle sentinel = max_pages * page_size.
          tables: int32 [n_lanes, max_pages] block tables (-1 unallocated).

        Returns (out [n_lanes, 1, hidden] on the device, pool_kv).
        """
        k_pool, v_pool = pool_kv
        h = _as_tensor(hidden, self.device, self.compute_dtype)
        positions = _as_tensor(positions, self.device, torch.int32)
        tables = _as_tensor(tables, self.device, torch.int32)
        for i, p_block in enumerate(self.block_params):
            kv = (PagedKV(k_pool[i], tables), PagedKV(v_pool[i], tables))
            h, _ = self.family.block_apply(p_block, h, kv, positions, self.cfg)
        return h, (k_pool, v_pool)

    @torch.no_grad()
    def paged_mixed_step(self, hidden, pool_kv, positions, tables,
                         chunk_hidden, chunk_lane: int, chunk_pos: int):
        """One mixed step: every decode lane (one token each) plus ONE
        prefill chunk for ``chunk_lane``, block by block.

        Args:
          hidden: [n_lanes, 1, hidden] (idle lanes: any finite filler).
          pool_kv: (k, v) page pools, updated IN PLACE.
          positions / tables: as in ``paged_decode_step``. The chunk lane
            must carry the idle sentinel in ``positions`` (its decode-side
            write drops); its table row is ``tables[chunk_lane]``.
          chunk_hidden: [1, seq, hidden], unpadded.
          chunk_lane / chunk_pos: which lane, and the chunk's first absolute
            token position.

        Returns (decode_out [n_lanes, 1, h], chunk_out [1, seq, h], pool_kv).
        """
        k_pool, v_pool = pool_kv
        h_dec = _as_tensor(hidden, self.device, self.compute_dtype)
        h_pf = _as_tensor(chunk_hidden, self.device, self.compute_dtype)
        positions = _as_tensor(positions, self.device, torch.int32)
        tables = _as_tensor(tables, self.device, torch.int32)
        table_row = tables[int(chunk_lane)][None].contiguous()
        seq = h_pf.shape[1]
        for i, p_block in enumerate(self.block_params):
            kv = (PagedKV(k_pool[i], tables), PagedKV(v_pool[i], tables))
            h_dec, _ = self.family.block_apply(p_block, h_dec, kv, positions, self.cfg)
            kv_pf = (PagedKV(k_pool[i], table_row), PagedKV(v_pool[i], table_row))
            h_pf, _ = self.family.block_apply(
                p_block, h_pf, kv_pf, int(chunk_pos), self.cfg, n_valid=seq
            )
        return h_dec, h_pf, (k_pool, v_pool)

    def chunk_plan(self, batch: int, total_seq: int, page_size: Optional[int] = None,
                   start: int = 0) -> Sequence[int]:
        """Split a long prefill so each chunk's attention footprint stays under
        max_chunk_size_bytes. On the card the paged kernels never materialize
        the [chunk, kv] logits, so the footprint is the chunk's activations,
        linear in its length; the plain CPU version materializes the logits,
        quadratic in the sequence. ``page_size`` aligns chunk ENDS to
        absolute page boundaries (whole-page writes, a partial tail page only
        on the final chunk); ``start`` is the absolute position of the first
        token."""
        if total_seq <= 1:
            return [total_seq]
        if self.device.type == "cuda":
            per_token = batch * self.compute_dtype.itemsize * (
                2 * self.hidden_size
                + self.cfg.intermediate_size
                + self.cfg.num_attention_heads * self.head_dim
            )
            max_chunk = max(self.max_chunk_size_bytes // max(per_token, 1), 1)
        else:
            denom = max(batch * self.cfg.num_attention_heads * total_seq * 4, 1)
            max_chunk = max(self.max_chunk_size_bytes // denom, 1)
        chunks = []
        remaining = total_seq
        pos = int(start)
        while remaining > 0:
            step = min(max_chunk, remaining)
            if page_size and step < remaining:
                end = pos + step
                aligned = end - end % page_size
                if aligned > pos:
                    step = aligned - pos
            chunks.append(step)
            remaining -= step
            pos += step
        return chunks
