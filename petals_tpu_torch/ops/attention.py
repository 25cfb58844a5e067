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
    (no family of petals_tpu calls it), ``tp_mesh`` and ring attention."""
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
