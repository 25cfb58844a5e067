"""Qwen2 / Qwen2.5 family (petals_tpu/models/qwen2/__init__.py): the llama
block with bias on q, k and v but not on o (``qkv_bias=True``,
``attention_bias=False``), and llama's client mapping, tied embeddings
included (Qwen2-0.5B/1.5B tie them).

A checkpoint with ``use_sliding_window=True`` gates its window per layer
(``max_window_layers``), which the uniform block config cannot say; it is
refused at load, as the reference refuses it (every released Qwen2/2.5
checkpoint ships ``use_sliding_window: false``)."""

from __future__ import annotations

import dataclasses

from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.llama.model import FAMILY as LLAMA_FAMILY
from petals_tpu_torch.models.registry import register_family


def config_from_hf(hf_config) -> LlamaBlockConfig:
    if getattr(hf_config, "use_sliding_window", False):
        raise NotImplementedError(
            "Qwen2 checkpoints with use_sliding_window=True gate the window "
            "per layer (max_window_layers); this build serves the (universal) "
            "full-attention configuration only"
        )
    base = LlamaBlockConfig.from_hf_config(hf_config)
    return dataclasses.replace(base, attention_bias=False, qkv_bias=True)


FAMILY = register_family(
    dataclasses.replace(LLAMA_FAMILY, name="qwen2", config_from_hf=config_from_hf)
)
