"""Rotary position embeddings (HF Llama "rotate_half" convention): the head
dim splits into halves [x1, x2]; rotated = [x1*cos - x2*sin, x2*cos + x1*sin].
Tables and rotation run in float32; the result is cast back."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def rotary_tables(
    positions: torch.Tensor,  # [batch, seq] absolute positions (int)
    head_dim: int,
    theta: float = 10000.0,
    rope_scaling: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [batch, seq, head_dim] for the given positions, on
    ``positions``' device. ``rope_scaling`` takes HF dicts of rope_type
    "llama3"; others raise NotImplementedError."""
    device = positions.device
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim)
    )
    if rope_scaling is not None:
        rope_type = rope_scaling.get("rope_type", rope_scaling.get("type", "default"))
        if rope_type == "llama3":
            inv_freq = _llama3_scale_inv_freq(inv_freq, rope_scaling)
        elif rope_type not in ("default", None):
            raise NotImplementedError(f"rope_type={rope_type!r} is not supported by this port yet")

    angles = positions.float()[..., None] * inv_freq  # [b, s, d/2]
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


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
