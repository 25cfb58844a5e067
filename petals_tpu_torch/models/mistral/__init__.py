"""Mistral family: the llama block with an all-layer sliding attention window
taken from the checkpoint (``sliding_window: null`` degrades to llama), and
llama's client mapping."""

from __future__ import annotations

import dataclasses

from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.llama.model import FAMILY as LLAMA_FAMILY
from petals_tpu_torch.models.registry import register_family


def config_from_hf(hf_config) -> LlamaBlockConfig:
    base = LlamaBlockConfig.from_hf_config(hf_config)
    return dataclasses.replace(base, sliding_window=getattr(hf_config, "sliding_window", None))


FAMILY = register_family(
    dataclasses.replace(LLAMA_FAMILY, name="mistral", config_from_hf=config_from_hf)
)
