"""Rotary position embeddings (HF Llama "rotate_half" convention): the head
dim splits into halves [x1, x2]; rotated = [x1*cos - x2*sin, x2*cos + x1*sin].
Tables and rotation run in float32; the result is cast back. Phi-3's
LongRoPE picks its factors per row from the real sequence length."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rotary_tables(
    positions: torch.Tensor,  # [batch, seq] absolute positions (int)
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
    n_valid=None,  # real (non-padding) rows of this chunk: an int or a 0-dim / [batch] tensor
    n_total=None,  # the final sequence length, when known up front (a chunked prefill)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [batch, seq, head_dim] for the given positions, on
    ``positions``' device. ``rope_scaling`` takes HF dicts of rope_type
    "linear" (every frequency divided by ``factor``), "llama3" or
    "longrope" (Phi-3; ``_longrope_inv_freq``, the only one that reads
    ``n_valid`` / ``n_total``); others raise NotImplementedError."""
    device = positions.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    table_scale = 1.0
    if rope_scaling is not None:
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type == "linear":
            inv_freq = inv_freq / rope_scaling["factor"]
        elif rope_type == "llama3":
            inv_freq = _llama3_scale_inv_freq(inv_freq, rope_scaling)
        elif rope_type == "longrope":
            inv_freq, table_scale = _longrope_inv_freq(inv_freq, positions, rope_scaling, n_valid, n_total)
        elif rope_type not in ("default", None):
            raise NotImplementedError(f"rope_type={rope_type!r} is not supported yet")

    angles = positions.float()[..., None] * inv_freq  # [b, s, d/2]
    emb = torch.cat([angles, angles], dim=-1)
    if table_scale == 1.0:
        return torch.cos(emb), torch.sin(emb)
    return torch.cos(emb) * table_scale, torch.sin(emb) * table_scale


def _longrope_inv_freq(inv_freq: torch.Tensor, positions: torch.Tensor, cfg: dict, n_valid=None, n_total=None):
    """Phi-3 LongRoPE (petals_tpu/ops/rotary.py ``_longrope_inv_freq``, HF's
    ``_compute_longrope_parameters``): per-dim extension factors, the long
    ones once a row's sequence runs past ``original_max_position_embeddings``,
    the short ones inside it, and a fixed attention scale on the tables.

    The choice is per ROW, from the real sequence end: ``n_total`` (the
    final prompt length, known up front) when given, else the row's first
    position plus ``n_valid`` (a padded chunk's real rows), else its last
    position + 1. It is a ``torch.where`` on the device: the lengths may be
    tensors of a captured step, and nothing reads them on the host.
    Returns (inv_freq [b, 1, d/2], table_scale)."""
    device = positions.device
    short, long = _factors(cfg, device)
    orig = float(cfg["original_max_position_embeddings"])
    factor = float(cfg.get("factor") or 1.0)
    attention_factor = cfg.get("attention_factor")
    if attention_factor is None:
        attention_factor = 1.0 if factor <= 1.0 else math.sqrt(1 + math.log(factor) / math.log(orig))
    batch = positions.shape[0]
    pos = positions.to(torch.int32)
    if n_total is not None:
        seq_len = torch.as_tensor(n_total, device=device).to(torch.int32).reshape(-1).expand(batch)
    elif n_valid is not None:
        seq_len = pos[:, 0] + torch.as_tensor(n_valid, device=device).to(torch.int32).reshape(-1).expand(batch)
    else:
        seq_len = pos.amax(dim=-1) + 1
    use_long = (seq_len.float() > orig)[:, None, None]  # [b, 1, 1]
    ext = torch.where(use_long, long[None, None, :], short[None, None, :])
    return inv_freq / ext, float(attention_factor)


_FACTORS: dict = {}  # (device, short, long) -> the factor tensors there


def _factors(cfg: dict, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The short and long factor lists as float32 tensors on ``device``,
    uploaded once: a captured step may not copy from the host, and its
    warm-up call uploads them first."""
    key = (device, tuple(cfg["short_factor"]), tuple(cfg["long_factor"]))
    if key not in _FACTORS:
        _FACTORS[key] = tuple(torch.tensor(f, dtype=torch.float32, device=device) for f in key[1:])
    return _FACTORS[key]


def _llama3_scale_inv_freq(inv_freq: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Llama-3.1 NTK-by-parts frequency scaling (HF _compute_llama3_parameters)."""
    factor = cfg["factor"]
    low_freq_factor = cfg["low_freq_factor"]
    high_freq_factor = cfg["high_freq_factor"]
    old_context_len = cfg["original_max_position_embeddings"]

    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor

    wavelen = 2 * math.pi / inv_freq
    smooth = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    scaled = torch.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return torch.where(is_medium, smoothed, scaled)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [batch, seq, heads, head_dim]; cos/sin [batch, seq, head_dim]."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, :, None, :] + rotated * sin[:, :, None, :]).to(x.dtype)
