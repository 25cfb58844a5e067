"""The falcon family with its client fields (petals_tpu/models/falcon/model.py):
the word embeddings, ``ln_f``, and the LM head, tied to the embeddings
unless the checkpoint unties it; and the sequence-classification head,
``score`` over ``ln_f``."""

from __future__ import annotations

import dataclasses

import torch

from petals_tpu_torch.models.bloom.model import client_head, client_norm
from petals_tpu_torch.models.client_common import ln_f_cls_head, pick_tensor, score_matrix
from petals_tpu_torch.models.falcon.block import FAMILY as BLOCK_FAMILY
from petals_tpu_torch.models.registry import register_family

CLIENT_PREFIXES = (
    "transformer.word_embeddings.",
    "transformer.ln_f.",
    "word_embeddings.",
    "ln_f.",
    "lm_head.",
)


def hf_to_client_params(tensors: dict, cfg) -> dict:
    """{"embed", "ln_f_w", "ln_f_b", "head"}; the head is ``embed.T`` (a
    view) unless the checkpoint unties it and ships ``lm_head.weight``."""
    embed = pick_tensor(tensors, "transformer.word_embeddings.weight", "word_embeddings.weight")
    if not cfg.tie_word_embeddings and "lm_head.weight" in tensors:
        head = tensors["lm_head.weight"].t()
    else:
        head = embed.t()
    return {
        "embed": embed,
        "ln_f_w": pick_tensor(tensors, "transformer.ln_f.weight", "ln_f.weight"),
        "ln_f_b": pick_tensor(tensors, "transformer.ln_f.bias", "ln_f.bias"),
        "head": head,
    }


def client_embed(params: dict, input_ids, cfg) -> torch.Tensor:
    embed = params["embed"]
    return embed[torch.as_tensor(input_ids, dtype=torch.long, device=embed.device)]


CLS_PREFIXES = tuple(p for p in CLIENT_PREFIXES if p != "lm_head.") + ("score.",)


def hf_to_cls_params(tensors: dict, cfg) -> dict:
    params = hf_to_client_params(tensors, cfg)
    params.pop("head")
    params["score"] = score_matrix(tensors)
    return params


def cls_head(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    return ln_f_cls_head(params, hidden, cfg.layer_norm_epsilon)


FAMILY = register_family(
    dataclasses.replace(
        BLOCK_FAMILY,
        hf_client_prefixes=CLIENT_PREFIXES,
        hf_to_client_params=hf_to_client_params,
        client_embed=client_embed,
        client_head=client_head,  # ln_f, then the float32 head: BLOOM's
        client_norm=client_norm,
        hf_cls_prefixes=CLS_PREFIXES,
        hf_to_cls_params=hf_to_cls_params,
        cls_head=cls_head,
    )
)
