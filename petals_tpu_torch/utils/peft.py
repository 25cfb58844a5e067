"""Server-side multi-tenant LoRA adapters (petals_tpu/utils/peft.py).

Many adapters stay resident on a server; each request picks one by name.

- ``load_adapter(path, family_name, block_range=...)`` reads a PEFT
  checkpoint (adapter_config.json + adapter_model.safetensors, through the
  port's own reader) and keeps the {leaf: (A [in, r], B [r, out])} pairs of
  the blocks this server hosts.
- ``stack_adapter(adapter, first_block, n_blocks, dtype, device)`` gives
  each block of the span its own pairs; a block the adapter does not touch
  gets zeros for every leaf it touches elsewhere, as the JAX package's
  stacked form does. The port keeps per-block dicts (its blocks are a
  list), so nothing is stacked.
- ``apply_adapter(block_params, per_block, scaling)`` wraps the affected
  leaves in ``LoraLinear``; ``models.common.mm`` computes
  ``x @ W + (x @ A) @ B * scaling``.

Target names resolve through the family's block architecture, so a
derived family (mistral over llama) finds llama's projections.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

# HF projection names -> the port's leaf names, per block architecture
_TARGET_MAP = {
    "llama": {
        "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
        "gate_proj": "wg", "up_proj": "wu", "down_proj": "wd",
    },
    "mixtral": {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo"},
    "bloom": {"query_key_value": None, "dense": "wo",  # fused qkv unsupported
              "dense_h_to_4h": "w_up", "dense_4h_to_h": "w_down"},
    "falcon": {"query_key_value": None, "dense": "wo",
               "dense_h_to_4h": "w_up", "dense_4h_to_h": "w_down"},
}


@dataclasses.dataclass
class LoraLinear:
    """A base weight (dense [in, out] or quantized) and its low-rank delta;
    consumed by ``models.common.mm``."""

    base: object
    lora_a: torch.Tensor  # [in, r]
    lora_b: torch.Tensor  # [r, out]
    scaling: float


@dataclasses.dataclass
class LoadedAdapter:
    name: str
    scaling: float
    rank: int
    # absolute block index -> {leaf name: (A [in, r], B [r, out]) float32 on the host}
    per_block: Dict[int, Dict[str, Tuple[torch.Tensor, torch.Tensor]]]


def target_map(family_name: str) -> dict:
    """The projection map of ``family_name``'s block architecture."""
    if family_name in _TARGET_MAP:
        return _TARGET_MAP[family_name]
    from petals_tpu_torch.models.registry import get_family

    try:
        family = get_family(family_name)
    except KeyError:
        return {}
    return _TARGET_MAP.get(family.block_arch or family.name, {})


def load_adapter(adapter_path: str, family_name: str, *, block_range: range,
                 name: Optional[str] = None) -> LoadedAdapter:
    """Read a PEFT checkpoint directory, keeping only the tensors of the
    blocks in ``block_range``."""
    from petals_tpu_torch.utils.safetensors_io import load_file

    with open(os.path.join(adapter_path, "adapter_config.json")) as f:
        cfg = json.load(f)
    rank = cfg["r"]
    scaling = cfg.get("lora_alpha", rank) / rank
    targets = target_map(family_name)
    per_block: Dict[int, Dict[str, list]] = {}
    tensors = load_file(os.path.join(adapter_path, "adapter_model.safetensors"))
    for key, tensor in tensors.items():
        parsed = _parse_adapter_key(key, targets)
        if parsed is None:
            continue
        block_idx, leaf, which = parsed
        if block_idx not in block_range:
            continue
        entry = per_block.setdefault(block_idx, {}).setdefault(leaf, [None, None])
        entry[0 if which == "A" else 1] = tensor.float().t().contiguous()  # [in, r] / [r, out]
    blocks = {
        idx: {leaf: (a, b) for leaf, (a, b) in leaves.items() if a is not None and b is not None}
        for idx, leaves in per_block.items()
    }
    adapter_name = name or os.path.basename(os.path.normpath(adapter_path))
    total = sum(len(v) for v in blocks.values())
    logger.info(f"Loaded adapter {adapter_name!r}: rank {rank}, {total} wrapped linears")
    return LoadedAdapter(adapter_name, scaling, rank, blocks)


def _parse_adapter_key(key: str, targets: dict):
    """'...layers.{i}.<module path>.<proj>.lora_{A,B}.weight' -> (i, leaf, A|B)."""
    parts = key.split(".")
    if "lora_A" in parts:
        which = "A"
    elif "lora_B" in parts:
        which = "B"
    else:
        return None
    try:
        layer_kw = "layers" if "layers" in parts else "h"
        block_idx = int(parts[parts.index(layer_kw) + 1])
    except (ValueError, IndexError):
        return None
    leaf = targets.get(parts[parts.index(f"lora_{which}") - 1])
    if leaf is None:
        return None
    return block_idx, leaf, which


def stack_adapter(adapter: LoadedAdapter, first_block: int, n_blocks: int, dtype: torch.dtype,
                  device=None) -> List[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """Each block of the span's {leaf: (A, B)} in ``dtype`` on ``device``;
    a block the adapter leaves alone gets zero pairs of the leaves it
    touches elsewhere."""
    shapes = {}
    for leaves in adapter.per_block.values():
        for leaf, (a, b) in leaves.items():
            shapes.setdefault(leaf, (a.shape, b.shape))
    out = []
    for i in range(first_block, first_block + n_blocks):
        block = {}
        for leaf, (a_shape, b_shape) in shapes.items():
            entry = adapter.per_block.get(i, {}).get(leaf)
            a, b = entry if entry is not None else (torch.zeros(a_shape), torch.zeros(b_shape))
            block[leaf] = (a.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype))
        out.append(block)
    return out


def shard_adapter(deltas: Dict[str, tuple], specs: Dict[str, Optional[int]], rank: int, n: int,
                  device) -> Dict[str, tuple]:
    """Tensor-parallel shard ``rank`` of ``n`` of one block's {leaf: (A, B)}
    on ``device``, split along each leaf's axis (parallel/tp.py
    ``span_param_specs``): an output-split leaf keeps A [in, r] whole and
    takes its part of B's columns; an input-split leaf takes its part of
    A's rows and keeps B [r, out] whole, so its ``(x @ A) @ B`` is a partial
    that sums across the shards with the base product's (``reduce_shards``).
    A replicated leaf keeps both whole."""
    out = {}
    for leaf, (a, b) in deltas.items():
        axis = specs.get(leaf)
        if axis == -1:
            size = b.shape[-1] // n
            b = b.narrow(-1, rank * size, size)
        elif axis == -2:
            size = a.shape[-2] // n
            a = a.narrow(-2, rank * size, size)
        out[leaf] = (a.to(device), b.to(device))
    return out


def apply_adapter(block_params: List[object], per_block: List[Dict[str, tuple]], scaling: float, *,
                  specs: Optional[Dict[str, Optional[int]]] = None, n_shards: int = 1) -> List[object]:
    """The span's blocks with the adapter's leaves wrapped in ``LoraLinear``
    (the same base tensors, no copy). A block is a dict, or under a mesh a
    list of tp shard dicts or ``GridParams`` (parallel/sp.py): each shard
    then wraps its part of the pairs (``shard_adapter`` along ``specs``) on
    its own device."""
    from petals_tpu_torch.parallel.sp import map_shards

    def wrap(params: dict, rank: int, deltas: Dict[str, tuple]) -> dict:
        if specs is not None:
            leaf = next(iter(params.values()))  # every leaf of a shard lies on its device
            deltas = shard_adapter(deltas, specs, rank, n_shards, getattr(leaf, "data", leaf).device)
        params = dict(params)
        for leaf, (a, b) in deltas.items():
            if leaf not in params:
                logger.warning(f"Adapter targets unknown leaf {leaf!r}; skipping")
                continue
            params[leaf] = LoraLinear(params[leaf], a, b, scaling)
        return params

    return [map_shards(params, lambda p, t, d=deltas: wrap(p, t, d))
            for params, deltas in zip(block_params, per_block)]
