"""Turn a block's dense parameters into the served form: quantized matmul
weights, with qkv and gate+up fused for single-card serving (the port of
petals_tpu/utils/convert_block.py). A span that hosts LoRA adapters
loads unfused: the adapters target the separate projections
(utils/peft.py)."""

from __future__ import annotations

import enum
from typing import Dict, Set

import torch

from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, quantize
from petals_tpu_torch.utils.convert import _stack


class QuantType(str, enum.Enum):
    NONE = "none"
    INT8 = "int8"  # per-output-column absmax int8
    NF4 = "nf4"  # QLoRA-style 4-bit normal float
    NF4A = "nf4a"  # NF4-fitted cubic levels: the 4-bit serving default
    INT4 = "int4"  # blockwise affine 4-bit
    # +o: the top in/64 input channels kept dense bf16 (4.5 bits/param)
    NF4A_O = "nf4a+o"
    INT4_O = "int4+o"


# The matmul weights of each block architecture (norms, biases and
# Mixtral's router stay dense). Mixtral's expert stacks (3-D leaves [E, in,
# out]) are quantized expert by expert.
QUANTIZABLE_LEAVES: Dict[str, Set[str]] = {
    "llama": {"wq", "wk", "wv", "wo", "wg", "wu", "wd"},
    "bloom": {"wq", "wk", "wv", "wo", "w_up", "w_down"},
    "falcon": {"wq", "wk", "wv", "wo", "w_up", "w_down"},
    "mixtral": {"wq", "wk", "wv", "wo", "w1", "w2", "w3"},
    "gemma2": {"wq", "wk", "wv", "wo", "wg", "wu", "wd"},
}

# Leaves fused into one matmul each: fewer kernel launches per block (none
# for bloom, falcon and mixtral, as in the JAX package; gemma2's as llama's). Fusion
# happens on the DENSE weights before quantization; every kind's scales are
# per output column, so the fused leaf quantizes to the same bytes as the
# parts side by side.
_FUSE_GROUPS: Dict[str, tuple] = {
    "llama": (
        ("wqkv", ("wq", "wk", "wv"), "bqkv", ("bq", "bk", "bv")),
        ("wgu", ("wg", "wu"), "bgu", ("bg", "bu")),
    ),
    "gemma2": (
        ("wqkv", ("wq", "wk", "wv"), "bqkv", ("bq", "bk", "bv")),
        ("wgu", ("wg", "wu"), "bgu", ("bg", "bu")),
    ),
}


def _block_arch(family_name: str) -> str:
    """The block architecture keying the tables above (mistral is a
    llama-architecture block registered under its own model_type)."""
    if family_name in QUANTIZABLE_LEAVES:
        return family_name
    from petals_tpu_torch.models.registry import get_family

    try:
        family = get_family(family_name)
    except KeyError:
        return family_name
    return family.block_arch or family.name


def convert_block_params(params: dict, family_name: str, quant_type, *, fuse: bool = False) -> dict:
    """Quantize one (unstacked) block's matmul weights in place of the dense
    leaves; ``fuse=True`` first merges qkv and gate+up into single leaves.

    A copy of the dict is consumed leaf by leaf, dropping each dense weight
    once its quantized form exists: a caller that keeps no reference of its
    own (the server's load path) frees each dense weight on the device
    before the next one is encoded."""
    quant_type = QuantType(quant_type)
    if quant_type == QuantType.NONE:
        return params
    arch = _block_arch(family_name)
    params = dict(params)
    if fuse:
        for fused_w, parts, fused_b, bias_parts in _FUSE_GROUPS.get(arch, ()):
            if all(p in params for p in parts):
                params[fused_w] = torch.cat([params.pop(p) for p in parts], dim=1)
                if all(b in params for b in bias_parts):
                    params[fused_b] = torch.cat([params.pop(b) for b in bias_parts], dim=0)
    quantizable = QUANTIZABLE_LEAVES.get(arch, set()) | {"wqkv", "wgu"}
    leaf_names = sorted(params)
    out = {}
    n_quantized = 0
    for name in list(params):
        leaf = params.pop(name)
        if not isinstance(leaf, torch.Tensor):  # a host-int leaf (gemma2's window)
            out[name] = leaf
        elif name in quantizable and leaf.dim() == 2:
            out[name] = quantize(leaf, quant_type.value)
            n_quantized += 1
        elif name in quantizable and leaf.dim() == 3:  # expert stacks [E, in, out]
            # the BASE kind: the mixtral block slices experts itself, and
            # the outlier side-arrays do not ride that path
            base = quant_type.value.removesuffix("+o")
            out[name] = _stack([quantize(leaf[e], base) for e in range(leaf.shape[0])])
            n_quantized += 1
        else:
            out[name] = leaf
        del leaf
    if not n_quantized:
        raise ValueError(
            f"quant_type={quant_type.value!r} requested but no quantizable leaves matched for "
            f"family {family_name!r} (block arch {arch!r}; leaves: {leaf_names})"
        )
    return out


def block_size_bytes(params: dict) -> int:
    return sum(
        leaf.nbytes if isinstance(leaf, QUANTIZED_TYPES) else leaf.numel() * leaf.element_size()
        for leaf in params.values()
        if isinstance(leaf, (torch.Tensor, *QUANTIZED_TYPES))
    )
