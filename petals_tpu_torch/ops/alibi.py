"""ALiBi slopes (BLOOM, Falcon-RW), the port of petals_tpu/ops/alibi.py:
per-head slopes that the attention kernels fuse into the scores as
``slopes[h] * j`` (j the absolute kv position), HF's schedule included for
a head count that is not a power of two (BLOOM-176B's 112)."""

from __future__ import annotations

import math

import torch


def build_alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [num_heads], float32, on ``device``."""
    closest_power_of_2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest_power_of_2) - 3)))
    powers = torch.arange(1, 1 + closest_power_of_2, dtype=torch.float32, device=device)
    slopes = base**powers
    if closest_power_of_2 != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest_power_of_2) - 3)))
        num_remaining = num_heads - closest_power_of_2
        extra_powers = torch.arange(1, 1 + 2 * num_remaining, 2, dtype=torch.float32, device=device)
        slopes = torch.cat([slopes, extra_base**extra_powers])
    return slopes
