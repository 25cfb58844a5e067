"""The bloom family with its client fields (petals_tpu/models/bloom/model.py):
the word embeddings and their LayerNorm, ``ln_f``, and the LM head tied to
the embeddings; and the sequence-classification head, ``score`` over
``ln_f``."""

from __future__ import annotations

import dataclasses

import torch

from petals_tpu_torch.models.bloom.block import FAMILY as BLOCK_FAMILY
from petals_tpu_torch.models.client_common import full_float32_matmuls, ln_f_cls_head, pick_tensor, score_matrix
from petals_tpu_torch.models.common import layer_norm
from petals_tpu_torch.models.registry import register_family

CLIENT_PREFIXES = (
    "transformer.word_embeddings.",
    "transformer.word_embeddings_layernorm.",
    "transformer.ln_f.",
    "word_embeddings.",
    "word_embeddings_layernorm.",
    "ln_f.",
    "lm_head.",
)


def hf_to_client_params(tensors: dict, cfg) -> dict:
    """{"embed", "emb_ln_w", "emb_ln_b", "ln_f_w", "ln_f_b", "head"}; the
    head is ``embed.T`` (a view: BLOOM ties them)."""
    embed = pick_tensor(tensors, "transformer.word_embeddings.weight", "word_embeddings.weight")
    return {
        "embed": embed,
        "emb_ln_w": pick_tensor(tensors, "transformer.word_embeddings_layernorm.weight",
                                "word_embeddings_layernorm.weight"),
        "emb_ln_b": pick_tensor(tensors, "transformer.word_embeddings_layernorm.bias",
                                "word_embeddings_layernorm.bias"),
        "ln_f_w": pick_tensor(tensors, "transformer.ln_f.weight", "ln_f.weight"),
        "ln_f_b": pick_tensor(tensors, "transformer.ln_f.bias", "ln_f.bias"),
        "head": embed.t(),
    }


def client_embed(params: dict, input_ids, cfg) -> torch.Tensor:
    embed = params["embed"]
    hidden = embed[torch.as_tensor(input_ids, dtype=torch.long, device=embed.device)]
    return layer_norm(hidden, params["emb_ln_w"], params["emb_ln_b"], cfg.layer_norm_epsilon)


def client_norm(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """``ln_f`` alone (the bare model's last hidden state)."""
    return layer_norm(hidden, params["ln_f_w"], params["ln_f_b"], cfg.layer_norm_epsilon)


def client_head(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """``ln_f``, then a float32 product with the float32 head (held in
    float32 from load, client/from_pretrained.py)."""
    head = params["head"]
    normed = client_norm(params, hidden.to(head.device), cfg).float()
    with full_float32_matmuls():
        return torch.matmul(normed, head.float())


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
        client_head=client_head,
        client_norm=client_norm,
        hf_cls_prefixes=CLS_PREFIXES,
        hf_to_cls_params=hf_to_cls_params,
        cls_head=cls_head,
    )
)
