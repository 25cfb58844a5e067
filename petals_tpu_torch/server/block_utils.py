"""Block sizing and the automatic num_blocks (the port's copy of
petals_tpu/server/block_utils.py): how many blocks of a model fit the card
beside the KV budget and a reserve. The card's memory comes from torch;
where there is no card, the caller passes ``memory_limit_bytes``."""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from petals_tpu_torch.ops.quant import BITS_PER_PARAM

logger = logging.getLogger(__name__)

AUTOGRAD_RESERVE_FRACTION = 0.15  # headroom for activations and step buffers


def block_params_count(family, cfg) -> int:
    return int(sum(math.prod(t.shape) for t in family.block_param_shapes(cfg, torch.bfloat16).values()))


def estimated_block_size_bytes(family, cfg, quant_type: str = "none") -> int:
    """Bytes of one served block at the given quantization (nf4: 4.25 bits a
    parameter)."""
    return int(block_params_count(family, cfg) * BITS_PER_PARAM[quant_type] / 8)


def device_memory_bytes(device=None) -> Optional[int]:
    """Total memory of the CUDA card ``device`` (default: the current one),
    or None where there is no card."""
    if not torch.cuda.is_available():
        return None
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def choose_num_blocks(
    family,
    cfg,
    *,
    quant_type: str = "none",
    attn_cache_bytes: int = 0,
    memory_limit_bytes: Optional[int] = None,
    device=None,
) -> int:
    """How many blocks fit the memory beside the KV budget and the reserve."""
    memory = memory_limit_bytes or device_memory_bytes(device)
    if memory is None:
        logger.warning("Unknown device memory; defaulting to serving all blocks")
        return cfg.num_hidden_layers
    usable = memory * (1 - AUTOGRAD_RESERVE_FRACTION) - attn_cache_bytes
    per_block = estimated_block_size_bytes(family, cfg, quant_type)
    n = min(max(int(usable // per_block), 1), cfg.num_hidden_layers)
    logger.info(
        f"Auto-selected {n} blocks ({per_block / 2**20:.0f} MiB each, "
        f"{memory / 2**30:.1f} GiB device memory, quant={quant_type})"
    )
    return n
