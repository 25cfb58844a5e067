"""The client's embeddings, final norm and LM head for llama-layout
families (``model.embed_tokens`` / ``model.norm`` / ``lm_head``, RMSNorm,
optional weight tying), the port of petals_tpu/models/client_common.py,
and what the bloom and falcon client pieces share, the sequence
classification heads among them (the ``score`` linear over the final
norm's output, float32)."""

from __future__ import annotations

import contextlib

import torch

from petals_tpu_torch.models.common import layer_norm, rms_norm

LLAMA_STYLE_CLIENT_PREFIXES = ("model.embed_tokens.", "model.norm.", "lm_head.")


def pick_tensor(tensors: dict, *names: str):
    """The first of ``names`` the checkpoint holds (a full model's prefixed
    name, or a bare model's)."""
    for name in names:
        if name in tensors:
            return tensors[name]
    raise KeyError(f"None of {names} found in checkpoint")


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


# sequence classification (HF *ForSequenceClassification): embeddings, the
# final norm and the ``score`` linear on the client, the blocks remote

LLAMA_STYLE_CLS_PREFIXES = ("model.embed_tokens.", "model.norm.", "score.")


def score_matrix(tensors: dict) -> torch.Tensor:
    """HF stores ``score`` [num_labels, hidden]; the client keeps [hidden, num_labels]."""
    return tensors["score.weight"].t().contiguous()


def llama_style_hf_to_cls_params(tensors: dict, cfg) -> dict:
    return {"embed": tensors["model.embed_tokens.weight"], "norm": tensors["model.norm.weight"],
            "score": score_matrix(tensors)}


def _score(normed: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    with full_float32_matmuls():
        return torch.matmul(normed.float(), score.float())


def llama_style_cls_head(params: dict, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """Per-position float32 label logits: the final RMSNorm, then ``score``
    (the model pools them: it needs the input ids)."""
    score = params["score"]
    return _score(rms_norm(hidden.to(score.device), params["norm"], cfg.rms_norm_eps), score)


def ln_f_cls_head(params: dict, hidden: torch.Tensor, eps: float) -> torch.Tensor:
    """Label logits of a family whose final norm is the LayerNorm ``ln_f``
    (bloom, falcon): ``ln_f``, then ``score``."""
    score = params["score"]
    return _score(layer_norm(hidden.to(score.device), params["ln_f_w"], params["ln_f_b"], eps), score)
