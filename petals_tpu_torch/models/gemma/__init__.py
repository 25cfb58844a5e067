"""Gemma (v1) family (petals_tpu/models/gemma/__init__.py): the llama block
with four deltas, none of them a new block.

- RMSNorm computes ``x_normed * (1 + w)``: every norm weight is folded to
  ``1 + w`` in float32 at load, after which the llama block's
  ``x_normed * w`` is the same; the folded norms are ``cast_exempt`` (a
  bf16 ``1 + w`` would round away what the unfolded form keeps).
- The MLP's GeLU rides ``hidden_act`` (models/llama/config.py).
- The client's embedding is scaled by sqrt(hidden), the factor rounded to
  the embedding's dtype first, as HF's normalizer is.
- The head is tied to the embeddings (HF GemmaConfig's default).

The sequence-classification client folds its final norm the same way
(``hf_to_cls_params``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from petals_tpu_torch.models.client_common import (
    llama_style_client_embed,
    llama_style_hf_to_client_params,
    llama_style_hf_to_cls_params,
)
from petals_tpu_torch.models.llama.block import hf_to_block_params as llama_block_params
from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.llama.model import FAMILY as LLAMA_FAMILY
from petals_tpu_torch.models.registry import register_family

# HF GemmaConfig's defaults for the keys a checkpoint's config.json may omit
# (``save_pretrained`` writes only what differs from PretrainedConfig's)
_HF_DEFAULTS = dict(tie_word_embeddings=True, hidden_act="gelu_pytorch_tanh", head_dim=256, rms_norm_eps=1e-6)


class _WithDefaults:
    """Attribute view of a config namespace with HF's defaults behind it."""

    def __init__(self, hf_config, defaults: dict):
        self._cfg, self._defaults = hf_config, defaults

    def __getattr__(self, name):
        if hasattr(self._cfg, name):
            return getattr(self._cfg, name)
        if name in self._defaults:
            return self._defaults[name]
        raise AttributeError(name)


def config_from_hf(hf_config) -> LlamaBlockConfig:
    return LlamaBlockConfig.from_hf_config(_WithDefaults(hf_config, _HF_DEFAULTS))


def fold_norm(w: torch.Tensor) -> torch.Tensor:
    """Gemma's RMSNorm weight ``w`` as the llama block's: ``1 + w`` in float32."""
    return w.float() + 1.0


def hf_to_block_params(tensors: dict, cfg: LlamaBlockConfig) -> dict:
    params = llama_block_params(tensors, cfg)
    params["ln1"] = fold_norm(params["ln1"])
    params["ln2"] = fold_norm(params["ln2"])
    return params


def hf_to_client_params(tensors: dict, cfg) -> dict:
    params = llama_style_hf_to_client_params(tensors, cfg)
    params["norm"] = fold_norm(params["norm"])
    return params


def hf_to_cls_params(tensors: dict, cfg) -> dict:
    # the classifier runs the same final norm: folded here too
    params = llama_style_hf_to_cls_params(tensors, cfg)
    params["norm"] = fold_norm(params["norm"])
    return params


def client_embed(params: dict, input_ids, cfg) -> torch.Tensor:
    h = llama_style_client_embed(params, input_ids, cfg)
    # HF casts the sqrt(hidden) normalizer to the embedding's dtype first
    return h * torch.tensor(math.sqrt(cfg.hidden_size), dtype=torch.float32).to(h.dtype)


FAMILY = register_family(
    dataclasses.replace(
        LLAMA_FAMILY,
        name="gemma",
        config_from_hf=config_from_hf,
        hf_to_block_params=hf_to_block_params,
        hf_to_client_params=hf_to_client_params,
        hf_to_cls_params=hf_to_cls_params,
        client_embed=client_embed,
        cast_exempt=("ln1", "ln2", "norm"),
    )
)
