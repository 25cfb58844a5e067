"""The llama family with its client fields (embeddings, final norm, LM
head), as petals_tpu/models/llama/model.py registers it; mistral and qwen2
derive from this family."""

from __future__ import annotations

import dataclasses

from petals_tpu_torch.models.client_common import (
    LLAMA_STYLE_CLIENT_PREFIXES,
    llama_style_client_embed,
    llama_style_client_head,
    llama_style_client_norm,
    llama_style_hf_to_client_params,
)
from petals_tpu_torch.models.llama.block import FAMILY as BLOCK_FAMILY
from petals_tpu_torch.models.registry import register_family

FAMILY = register_family(
    dataclasses.replace(
        BLOCK_FAMILY,
        hf_client_prefixes=LLAMA_STYLE_CLIENT_PREFIXES,
        hf_to_client_params=llama_style_hf_to_client_params,
        client_embed=llama_style_client_embed,
        client_head=llama_style_client_head,
        client_norm=llama_style_client_norm,
    )
)
