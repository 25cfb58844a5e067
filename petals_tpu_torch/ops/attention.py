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

from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


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
) -> torch.Tensor:
    """Causal multi-head attention. A paged cache (``PagedKV`` in place of the
    dense buffers) goes to the paged-attention kernels; a dense buffer to
    ``attend_reference``."""
    from petals_tpu_torch.ops.paged_attention import PagedKV

    if isinstance(k, PagedKV):
        from petals_tpu_torch.ops.paged_flash_attention import paged_attend_dispatch

        return paged_attend_dispatch(
            q, k, v, q_offset=q_offset, kv_length=kv_length,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    return attend_reference(
        q, k, v, q_offset=q_offset, kv_length=kv_length,
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
    )


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
) -> torch.Tensor:
    """Plain attention in float32. ``q_offset``/``kv_length`` are scalars (one
    shared history length) or [batch] tensors (per-lane positions)."""
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
    mask = mask.expand(mask.shape[0], q_len, kv_buf_len)

    logits = torch.where(mask[:, None], logits, DEFAULT_MASK_VALUE)
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = weights * mask[:, None]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-30)

    wg = weights.reshape(batch, num_kv_heads, group, q_len, kv_buf_len)
    out = torch.einsum("bkgqs,bskd->bqkgd", wg, vf)
    return out.reshape(batch, q_len, num_q_heads, head_dim).to(q.dtype)
