"""The client's embeddings, final norm and LM head for llama-layout
families (``model.embed_tokens`` / ``model.norm`` / ``lm_head``, RMSNorm,
optional weight tying), the port of petals_tpu/models/client_common.py:1-41.
The classification heads wait for A11/A13 (ROADMAP.md)."""

from __future__ import annotations

import contextlib

import torch

from petals_tpu_torch.models.common import rms_norm

LLAMA_STYLE_CLIENT_PREFIXES = ("model.embed_tokens.", "model.norm.", "lm_head.")


def llama_style_hf_to_client_params(tensors: dict, cfg) -> dict:
    """{"embed": [vocab, hidden], "norm": [hidden], "head": [hidden, vocab]};
    the head is ``embed.T`` (a view, no copy) when the checkpoint ties its
    embeddings or has no ``lm_head.weight``."""
    embed = tensors["model.embed_tokens.weight"]
    if cfg.tie_word_embeddings or "lm_head.weight" not in tensors:
        head = embed.t()
    else:
        head = tensors["lm_head.weight"].t()
    return {"embed": embed, "norm": tensors["model.norm.weight"], "head": head}


def llama_style_client_embed(params: dict, input_ids: torch.Tensor, cfg) -> torch.Tensor:
    embed = params["embed"]
    return embed[torch.as_tensor(input_ids, dtype=torch.long, device=embed.device)]


def llama_style_client_norm(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """The final RMSNorm alone (the bare model's last hidden state)."""
    return rms_norm(hidden, params["norm"], cfg.rms_norm_eps)


@contextlib.contextmanager
def full_float32_matmuls():
    """float32 products in full float32 on the card: TF32 off while active."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def llama_style_client_head(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """Final norm, then a float32 product with the float32 head. The head is
    held in float32 from load (``client/from_pretrained.py``), so no call
    casts it: for a 152064-token vocabulary that cast would be 2.2 GB a
    token."""
    head = params["head"]
    normed = rms_norm(hidden.to(head.device), params["norm"], cfg.rms_norm_eps).float()
    with full_float32_matmuls():
        return torch.matmul(normed, head.float())
