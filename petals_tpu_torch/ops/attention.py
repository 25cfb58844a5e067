"""Attention over a KV buffer: the dispatch every block calls, and its plain
reference.

Layouts (as in petals_tpu/ops/attention.py):
- q:    [batch, q_len, num_q_heads, head_dim]
- k, v: [batch, kv_len, num_kv_heads, head_dim] (GQA: hq % hkv == 0)

Query row i sits at absolute position ``q_offset + i`` and attends to kv
positions j with ``j <= q_offset + i`` and ``j < kv_length``; a sliding window
keeps only ``j > q_pos - window``. ALiBi follows BLOOM: bias[h, j] =
slopes[h] * j.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the attention kernels' wide-group arm: a GQA group of more than GROUP_TILE
# query heads is cut into tiles, each one more grid index over its kv head
# (csrc/hopper_wgmma.cuh group_tiles, the same rule)
GROUP_TILE = 16


def group_tiles(group: int) -> Tuple[int, int]:
    """(n, size): a GQA group cut into n = ceil(group / GROUP_TILE) tiles of
    ceil(group / n) query heads, the last one ragged (71 -> 5 tiles of 15,
    the last of 11; 29 -> 2 of 15, the last of 14; 16 -> one of 16)."""
    n = -(-group // GROUP_TILE)
    return n, -(-group // n)


def causal_work(first: int, n: int, kv_len: int, window: Optional[int] = None) -> Tuple[int, int]:
    """(kv rows some query row sees, visible (query, kv) pairs) of ``n``
    query rows at positions first..first + n - 1 over ``kv_len`` kv rows,
    causal and, with a window, windowed: row p sees
    [max(0, p - window + 1), min(p + 1, kv_len)). In closed form for rows
    within the kv rows (first + n <= kv_len), the kernels' work at capacity."""
    if n <= 0:
        return 0, 0
    if first + n > kv_len:
        raise ValueError(f"rows {first}..{first + n - 1} pass the {kv_len} kv rows")
    w = kv_len if window is None else min(int(window), kv_len)

    def upto(x: int) -> int:  # sum of min(j, w) for j = 1..x
        return x * (x + 1) // 2 if x <= w else w * (w + 1) // 2 + (x - w) * w

    return first + n - max(0, first - w + 1), upto(first + n) - upto(first)


def attend(
    q: torch.Tensor,
    k,
    v,
    *,
    q_offset=0,
    kv_length=None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    use_flash: bool = False,
) -> torch.Tensor:
    """Causal multi-head attention (petals_tpu/ops/attention.py ``attend``).

    A paged cache (``PagedKV`` in place of the dense buffers) goes to the
    paged-attention kernels. A dense buffer with ``use_flash``, scalar
    positions and a chunk above decode shapes (``flash_supported``: q_len >=
    8) goes to the flash-attention kernel (ops/flash_attention.py), which
    launches on CUDA tensors or raises. Decode shapes and per-lane (vector)
    positions take ``attend_reference``, the port of the JAX package's XLA
    path. ALiBi slopes (BLOOM, Falcon-RW), GQA groups of up to 71 query
    heads a kv head (Falcon-7B; ``group_tiles``) and Gemma-2's
    ``logit_softcap`` (cap * tanh(logits / cap) after the scale, before
    ALiBi and the mask) reach every kernel. Not ported: ``causal=False``
    (no family of petals_tpu calls it). Tensor and sequence parallelism
    call this on each shard's heads (``attend_maybe_ring``)."""
    from petals_tpu_torch.ops.paged_attention import PagedKV

    if isinstance(k, PagedKV):
        from petals_tpu_torch.ops.paged_flash_attention import paged_attend_dispatch

        return paged_attend_dispatch(
            q, k, v, q_offset=q_offset, kv_length=kv_length,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale, softcap=logit_softcap,
        )
    vector_pos = any(isinstance(p, torch.Tensor) and p.dim() > 0 for p in (q_offset, kv_length))
    if use_flash and not vector_pos:
        from petals_tpu_torch.ops.flash_attention import flash_attend, flash_supported

        if flash_supported(q, k, v, sliding_window=sliding_window):
            return flash_attend(
                q, k, v, q_offset=q_offset, kv_length=kv_length,
                alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale, softcap=logit_softcap,
            )
    return attend_reference(
        q, k, v, q_offset=q_offset, kv_length=kv_length,
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale, logit_softcap=logit_softcap,
    )


def attend_maybe_ring(
    q,  # one [b, rows, hq, d] query block a computing sp rank, in rank order
    k,  # the same ranks' new K rows, [b, rows, hkv, d] each
    v,
    *,
    kv,  # None (the stateless path), else one (k_buf, v_buf) a sp rank: the replicated cache's copies
    position,
    n_valid=None,
    use_flash: bool = False,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    layout=None,  # a GroupLayout when the computing ranks span processes (this process's ranks given)
):
    """The attention every family block calls (petals_tpu/ops/attention.py
    ``attend_maybe_ring``), on one tp shard's heads; the ranks that compute
    come from ``parallel.sp.seq_ranks``. Returns (one output a computing
    rank, rank 0's (k_all, v_all), or None on the stateless path). Under a
    ``layout`` the ranks given are this process's ranks [s0, s0 + n_s) of
    the layout's sp: the ring steps between processes, and the cached path
    gathers every rank's K/V rows first, so every process writes the whole
    chunk into its copies.

    - Stateless, several ranks: the ring (ops/ring_attention.py) over the
      chunk's K/V blocks, float32, never the flash kernel.
    - Stateless, one rank: causal attention of the chunk over itself.
    - Cached: every rank's K/V rows are written into every distinct copy
      of the cache (rank r's at ``position + r * rows``, its real rows only
      where ``n_valid`` marks padding), then each rank attends its query
      rows against its own copy with ``q_offset = position + r * rows`` and
      the chunk's whole ``kv_length``: the flash kernel on each query shard
      when ``use_flash``. One computing rank is the tp-only path (a decode
      step, a chunk that does not split), whose rows still reach every
      copy."""
    from petals_tpu_torch.models.common import update_kv_cache
    from petals_tpu_torch.parallel.sp import rank_n_valid

    n, first = (len(q), 0) if layout is None else (layout.sp, layout.s0)
    if kv is None:
        if n > 1:
            from petals_tpu_torch.ops.ring_attention import ring_attend

            return ring_attend(q, k, v, alibi_slopes=alibi_slopes, sliding_window=sliding_window,
                               layout=layout), None
        return [attend(q[0], k[0], v[0], q_offset=position, alibi_slopes=_on(alibi_slopes, q[0]),
                       sliding_window=sliding_window, use_flash=use_flash)], None
    rows = q[0].shape[1]
    if layout is not None:
        k, v = (_gather_ranks(x, layout) for x in (k, v))
    written = {}
    for k_buf, v_buf in kv:
        if id(k_buf) in written:
            continue
        for r in range(n):
            real = rank_n_valid(n_valid, r, rows) if n > 1 else n_valid
            if r and not isinstance(real, torch.Tensor) and real == 0:
                continue  # padding alone: nothing to write (its position may lie past the buffer)
            out = update_kv_cache((k_buf, v_buf), _beside(k[r], k_buf), _beside(v[r], v_buf),
                                  position + r * rows if r else position, real)
            if not r:
                written[id(k_buf)] = out[2]
    if n == 1:
        kv_length = written[id(kv[0][0])]
    else:
        kv_length = position + (n * rows if n_valid is None else n_valid)
    outs = []
    for i, qi in enumerate(q):
        r = first + i
        k_buf, v_buf = kv[i]
        length = kv_length.to(qi.device) if isinstance(kv_length, torch.Tensor) else kv_length
        outs.append(attend(
            qi, k_buf, v_buf, q_offset=position + r * rows if r else position, kv_length=length,
            alibi_slopes=_on(alibi_slopes, qi), sliding_window=sliding_window, use_flash=use_flash,
        ))
    return outs, kv[0]


def _gather_ranks(parts, layout):
    """Every sp rank's rows of one shard, in rank order, from this
    process's ranks' ``parts``: a gather over the sp group."""
    from petals_tpu_torch.parallel.collectives import gather_rows

    return list(gather_rows(torch.cat(list(parts), dim=1), layout).split(parts[0].shape[1], dim=1))


def _beside(rows: torch.Tensor, buf) -> torch.Tensor:
    """``rows`` on a dense buffer's device (a paged cache, never replicated,
    takes them where they are)."""
    return rows.to(buf.device) if isinstance(buf, torch.Tensor) else rows


def _on(slopes: Optional[torch.Tensor], like: torch.Tensor) -> Optional[torch.Tensor]:
    return None if slopes is None else slopes.to(like.device)


def attend_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset=0,
    kv_length=None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention in float32. ``q_offset``/``kv_length`` are scalars (one
    shared history length) or [batch] tensors (per-lane positions).
    ``logit_softcap`` (Gemma-2) caps the scaled logits as petals_tpu does,
    tanh(l / cap) * cap before ALiBi and the mask. ``kv_valid`` [batch,
    kv_len] bool, where given, hides the positions it marks False from every
    query (a paged cache's holes)."""
    batch, q_len, num_q_heads, head_dim = q.shape
    _, kv_buf_len, num_kv_heads, _ = k.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"query heads {num_q_heads} not a multiple of kv heads {num_kv_heads}")
    group = num_q_heads // num_kv_heads
    if scale is None:
        scale = head_dim**-0.5
    if kv_length is None:
        kv_length = kv_buf_len
    device = q.device

    qf, kf, vf = q.float(), k.float(), v.float()
    qg = qf.reshape(batch, q_len, num_kv_heads, group, head_dim)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    logits = logits.reshape(batch, num_q_heads, q_len, kv_buf_len)
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap

    kv_pos = torch.arange(kv_buf_len, dtype=torch.int32, device=device)
    if alibi_slopes is not None:
        bias = alibi_slopes.float()[:, None, None] * kv_pos.float()[None, None, :]
        logits = logits + bias[None]

    q_off = torch.as_tensor(q_offset, dtype=torch.int32, device=device).reshape(-1, 1)
    q_pos = q_off + torch.arange(q_len, dtype=torch.int32, device=device)[None, :]
    kv_len = torch.as_tensor(kv_length, dtype=torch.int32, device=device).reshape(-1, 1, 1)
    mask = (kv_pos[None, None, :] < kv_len) & (kv_pos[None, None, :] <= q_pos[:, :, None])
    if sliding_window is not None:
        mask = mask & (kv_pos[None, None, :] > q_pos[:, :, None] - sliding_window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    mask = mask.expand(mask.shape[0], q_len, kv_buf_len)

    logits = torch.where(mask[:, None], logits, DEFAULT_MASK_VALUE)
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = weights * mask[:, None]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-30)

    wg = weights.reshape(batch, num_kv_heads, group, q_len, kv_buf_len)
    out = torch.einsum("bkgqs,bskd->bqkgd", wg, vf)
    return out.reshape(batch, q_len, num_q_heads, head_dim).to(q.dtype)
