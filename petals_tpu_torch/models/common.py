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
    a scalar (one shared history length) or a [batch] tensor (per-lane
    positions of a batched decode step)."""
    offs = torch.arange(seq, dtype=torch.int32, device=device)
    if isinstance(position, torch.Tensor) and position.dim() == 1:
        return position.to(device=device, dtype=torch.int32)[:, None] + offs[None, :]
    return (int(position) + offs)[None, :].expand(batch, seq)


def update_kv_cache(kv, k_new: torch.Tensor, v_new: torch.Tensor, position, n_valid=None):
    """Write k_new/v_new ([b, s, hkv, d]) into the cache at ``position`` and
    return (k_all, v_all, kv_length) to attend over.

    ``kv`` is a (k, v) pair of dense buffers [b, max_len, hkv, d] (scalar
    position) or of ``PagedKV``s. Both are written IN PLACE. ``n_valid`` marks
    how many of the ``s`` new rows are real; padded rows are dropped."""
    from petals_tpu_torch.ops.paged_attention import PagedKV, paged_update_kv

    k_buf, v_buf = kv
    if isinstance(k_buf, PagedKV):
        return paged_update_kv(k_buf, v_buf, k_new, v_new, position, n_valid)
    if isinstance(position, torch.Tensor) and position.dim() > 0:
        raise ValueError(
            "per-lane writes into dense buffers (the dense lane pool) are not "
            "supported by this port yet"
        )
    pos, seq = int(position), k_new.shape[1]
    n = seq if n_valid is None else int(n_valid)
    if pos + n > k_buf.shape[1]:
        raise ValueError(
            f"KV cache overflow: position {pos} + {n} new tokens > buffer length {k_buf.shape[1]}"
        )
    k_buf[:, pos : pos + n] = k_new[:, :n].to(k_buf.dtype)
    v_buf[:, pos : pos + n] = v_new[:, :n].to(v_buf.dtype)
    return k_buf, v_buf, pos + n
