"""Phi-3 family (petals_tpu/models/phi3/__init__.py): the llama block with
two checkpoint and config deltas.

- q/k/v ship fused as ``self_attn.qkv_proj`` and gate/up as
  ``mlp.gate_up_proj``; they are split back into the llama leaves at load
  (the serving conversion fuses them again, utils/convert_block.py).
- LongRoPE (mini-128k): per-dim short/long factors chosen from the real
  sequence length, and a fixed attention scale on the tables
  (ops/rotary.py). The factor lists ride the hashable ``rope_scaling``
  tuple together with the top-level ``original_max_position_embeddings``
  and ``factor`` = max / original, so the block config is self-contained.

As in petals_tpu, the block config keeps no ``sliding_window``; no bias
anywhere."""

from __future__ import annotations

import dataclasses

from petals_tpu_torch.models.llama.block import hf_to_block_params as llama_block_params
from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.llama.model import FAMILY as LLAMA_FAMILY
from petals_tpu_torch.models.registry import register_family


class _WithoutRopeScaling:
    """Attribute view of a config namespace with ``rope_scaling`` hidden: the
    base reader keeps scalar values only, and the sanitized tuple is put in
    afterwards."""

    def __init__(self, hf_config):
        self._cfg = hf_config

    def __getattr__(self, name):
        if name == "rope_scaling":
            return None
        return getattr(self._cfg, name)


def config_from_hf(hf_config) -> LlamaBlockConfig:
    rope_scaling = getattr(hf_config, "rope_scaling", None)
    sanitized = None
    if rope_scaling is not None:
        entries = dict(rope_scaling)
        if entries.get("rope_type", entries.get("type")) == "longrope":
            orig = getattr(hf_config, "original_max_position_embeddings", None)
            if orig:
                entries["original_max_position_embeddings"] = orig
                entries["factor"] = hf_config.max_position_embeddings / orig
            else:
                entries["original_max_position_embeddings"] = hf_config.max_position_embeddings
        sanitized = tuple(sorted((k, tuple(v) if isinstance(v, (list, tuple)) else v) for k, v in entries.items()))
    base = LlamaBlockConfig.from_hf_config(_WithoutRopeScaling(hf_config))
    return dataclasses.replace(base, rope_scaling=sanitized)


def hf_to_block_params(tensors: dict, cfg: LlamaBlockConfig) -> dict:
    """Split the fused rows (HF [out, in]: q/k/v and gate/up stack along out)
    back into the llama leaves."""
    tensors = dict(tensors)
    qkv = tensors.pop("self_attn.qkv_proj.weight")
    nq, nkv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    tensors["self_attn.q_proj.weight"] = qkv[:nq]
    tensors["self_attn.k_proj.weight"] = qkv[nq : nq + nkv]
    tensors["self_attn.v_proj.weight"] = qkv[nq + nkv : nq + 2 * nkv]
    gu = tensors.pop("mlp.gate_up_proj.weight")
    tensors["mlp.gate_proj.weight"] = gu[: cfg.intermediate_size]
    tensors["mlp.up_proj.weight"] = gu[cfg.intermediate_size :]
    return llama_block_params(tensors, cfg)


FAMILY = register_family(
    dataclasses.replace(
        LLAMA_FAMILY,
        name="phi3",
        config_from_hf=config_from_hf,
        hf_to_block_params=hf_to_block_params,
    )
)
