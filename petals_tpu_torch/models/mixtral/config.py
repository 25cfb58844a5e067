"""Mixtral (MoE) family block config (petals_tpu/models/mixtral/config.py),
read from a namespace of config.json with HF MixtralConfig's defaults where
a key is absent (``save_pretrained`` writes only what differs from them)."""

from __future__ import annotations

import dataclasses
from typing import Optional

# HF MixtralConfig's defaults (transformers' configuration_mixtral.py)
_HF_DEFAULTS = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, head_dim=None, rms_norm_eps=1e-5,
    rope_theta=1e6, sliding_window=None, num_experts_per_tok=2, num_local_experts=8,
    tie_word_embeddings=False, hidden_act="silu",
)


@dataclasses.dataclass(frozen=True)
class MixtralBlockConfig:
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    num_hidden_layers: int
    num_local_experts: int
    num_experts_per_tok: int
    rms_norm_eps: float
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None
    vocab_size: int = 32000
    tie_word_embeddings: bool = False

    @classmethod
    def from_hf_config(cls, hf_config) -> "MixtralBlockConfig":
        def get(key):
            return getattr(hf_config, key, _HF_DEFAULTS[key])

        if get("hidden_act") != "silu":
            raise NotImplementedError(f"hidden_act {get('hidden_act')!r} is not supported by this port yet")
        return cls(
            hidden_size=get("hidden_size"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads"),
            head_dim=get("head_dim") or get("hidden_size") // get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_local_experts=get("num_local_experts"),
            num_experts_per_tok=get("num_experts_per_tok"),
            rms_norm_eps=get("rms_norm_eps"),
            rope_theta=get("rope_theta"),
            sliding_window=get("sliding_window"),
            vocab_size=get("vocab_size"),
            tie_word_embeddings=get("tie_word_embeddings"),
        )
