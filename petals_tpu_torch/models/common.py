"""Shared numerics for the model families: norms, activations, matmul
(dense or quantized), and KV-cache writes. Normalisations and activations
run in float32 and cast back, where petals_tpu/models/common.py does."""

from __future__ import annotations

import torch

from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, quant_matmul


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


ACTIVATIONS = {"silu": silu}


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul against a weight stored [in, out]: dense, or quantized
    (QuantizedLinear / OutlierQuantLinear, through ops/quant.py
    quant_matmul)."""
    if isinstance(w, QUANTIZED_TYPES):
        return quant_matmul(x, w)
    return x @ w


def absolute_positions(position, batch: int, seq: int, device) -> torch.Tensor:
    """[batch, seq] absolute positions of this chunk's tokens. ``position`` is
    a scalar (one shared history length: a host int, or a 0-dim tensor on
    ``device``, as a captured step passes it) or a [batch] tensor (per-lane
    positions of a batched decode step)."""
    offs = torch.arange(seq, dtype=torch.int32, device=device)
    if isinstance(position, torch.Tensor):
        pos = position.to(device=device, dtype=torch.int32)
        if pos.dim() == 1:
            return pos[:, None] + offs[None, :]
        return (pos + offs)[None, :].expand(batch, seq)
    return (int(position) + offs)[None, :].expand(batch, seq)


def update_kv_cache(kv, k_new: torch.Tensor, v_new: torch.Tensor, position, n_valid=None):
    """Write k_new/v_new ([b, s, hkv, d]) into the cache at ``position`` and
    return (k_all, v_all, kv_length) to attend over.

    ``kv`` is a (k, v) pair of dense buffers [b, max_len, hkv, d] or of
    ``PagedKV``s. Both are written IN PLACE. ``position`` is a scalar (one
    shared history length) or, for the dense lane pool's batched step, a [b]
    tensor: each row then writes at its own offset, kv_length comes back as a
    vector, and rows at or past the buffer's end (the idle sentinel) are
    DROPPED. ``n_valid`` marks how many of the ``s`` new rows are real; padded
    rows are dropped. A scalar ``position`` and ``n_valid`` may be host
    integers or 0-dim integer tensors on the rows' device (a captured step's
    chunk scalars). With host integers a dense write is a slice assignment
    and an overflow raises; with a tensor it goes through ``_drop_scatter_``,
    which drops padded rows and rows past the buffer without a host sync,
    the same bytes either way, and kv_length comes back as a tensor."""
    from petals_tpu_torch.ops.paged_attention import PagedKV, paged_update_kv

    k_buf, v_buf = kv
    if isinstance(k_buf, PagedKV):
        return paged_update_kv(k_buf, v_buf, k_new, v_new, position, n_valid)
    if isinstance(position, torch.Tensor) or isinstance(n_valid, torch.Tensor):
        return _update_dense_per_lane(k_buf, v_buf, k_new, v_new, position, n_valid)
    pos, seq = int(position), k_new.shape[1]
    n = seq if n_valid is None else int(n_valid)
    if pos + n > k_buf.shape[1]:
        raise ValueError(
            f"KV cache overflow: position {pos} + {n} new tokens > buffer length {k_buf.shape[1]}"
        )
    k_buf[:, pos : pos + n] = k_new[:, :n].to(k_buf.dtype)
    v_buf[:, pos : pos + n] = v_new[:, :n].to(v_buf.dtype)
    return k_buf, v_buf, pos + n


def _update_dense_per_lane(k_buf, v_buf, k_new, v_new, position, n_valid):
    """Write into dense buffers [b, max_len, hkv, d] at positions held as
    tensors: row (b, i) goes to ``position[b] + i`` (``position`` [b], per
    lane) or ``position + i`` (a 0-dim tensor or an int, shared); positions
    at or past ``max_len`` and rows past ``n_valid`` (an int or a 0-dim
    tensor) drop (the JAX package's scatter with mode="drop"). The drop is
    ``_drop_scatter_``'s: every index stays a tensor, no host sync."""
    from petals_tpu_torch.ops.paged_attention import _drop_scatter_

    batch, seq = k_new.shape[0], k_new.shape[1]
    buf_len = k_buf.shape[1]
    if not (k_buf.is_contiguous() and v_buf.is_contiguous()):
        raise ValueError("per-lane writes need contiguous dense buffers [batch, max_len, hkv, d]")
    if isinstance(position, torch.Tensor):
        pos = position.to(device=k_new.device, dtype=torch.long).reshape(-1, 1)
    else:
        pos = int(position)
    offs = torch.arange(seq, device=k_new.device)
    idx = pos + offs[None, :]  # [b, s], or [1, s] for a shared position
    ok = (idx >= 0) & (idx < buf_len)
    n = seq
    if n_valid is not None:
        n = n_valid if isinstance(n_valid, torch.Tensor) else int(n_valid)
        ok = ok & (offs[None, :] < n)
    lane = torch.arange(batch, device=k_new.device)[:, None]
    flat = torch.where(ok, lane * buf_len + idx, batch * buf_len).reshape(-1)
    _drop_scatter_(
        [(k_buf, k_new.reshape(batch * seq, *k_new.shape[2:])),
         (v_buf, v_new.reshape(batch * seq, *v_new.shape[2:]))],
        flat,
    )
    return k_buf, v_buf, position + n
