"""Gemma-2 family registration (petals_tpu/models/gemma2/__init__.py; the
block's notes are in block.py). Client side: gemma's sqrt(hidden)-scaled
embeddings, the folded final norm, and the tied head in float32 with the
final logit softcap tanh(logits / cap) * cap (HF Gemma2ForCausalLM)."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.client_common import (
    LLAMA_STYLE_CLIENT_PREFIXES,
    full_float32_matmuls,
    llama_style_client_norm,
)
from petals_tpu_torch.models.gemma import client_embed, hf_to_client_params
from petals_tpu_torch.models.gemma2 import block as block_mod
from petals_tpu_torch.models.gemma2.config import Gemma2BlockConfig
from petals_tpu_torch.models.registry import ModelFamily, register_family


def client_head(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """The final norm, the float32 product with the float32 head, then the
    final logit softcap."""
    head = params["head"]
    normed = llama_style_client_norm(params, hidden.to(head.device), cfg).float()
    with full_float32_matmuls():
        logits = torch.matmul(normed, head.float())
    cap = cfg.final_logit_softcapping
    if cap:
        logits = torch.tanh(logits / cap) * cap
    return logits


FAMILY = register_family(
    ModelFamily(
        name="gemma2",
        block_arch="gemma2",
        config_from_hf=Gemma2BlockConfig.from_hf_config,
        block_apply=block_mod.block_apply,
        hf_block_prefixes=block_mod._HF_BLOCK_PREFIXES,
        hf_to_block_params=block_mod.hf_to_block_params,
        block_param_shapes=block_mod.block_param_shapes,
        hf_client_prefixes=LLAMA_STYLE_CLIENT_PREFIXES,
        hf_to_client_params=hf_to_client_params,
        client_embed=client_embed,
        client_head=client_head,
        client_norm=llama_style_client_norm,
        cast_exempt=("ln1", "ln1_post", "ln2_pre", "ln2_post", "norm", "attn_window"),
    )
)
