"""Gemma-2 block config (petals_tpu/models/gemma2/config.py), read from a
namespace of config.json with HF Gemma2Config's defaults where a key is
absent."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# HF Gemma2Config's defaults (transformers' configuration_gemma2.py), and
# PretrainedConfig's tie_word_embeddings
_HF_DEFAULTS = dict(
    vocab_size=256000, hidden_size=2304, intermediate_size=9216, num_hidden_layers=26, num_attention_heads=8,
    num_key_value_heads=4, head_dim=256, rms_norm_eps=1e-6, rope_theta=10000.0, query_pre_attn_scalar=256,
    sliding_window=4096, layer_types=None, final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
    tie_word_embeddings=True,
)


@dataclasses.dataclass(frozen=True)
class Gemma2BlockConfig:
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    num_hidden_layers: int
    rms_norm_eps: float
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    # "sliding_attention" | "full_attention" per layer (HF layer_types)
    layer_types: Tuple[str, ...] = ()
    attn_logit_softcapping: Optional[float] = None
    final_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: float = 256.0
    hidden_act: str = "gelu_tanh"
    vocab_size: int = 256000
    tie_word_embeddings: bool = True

    @classmethod
    def from_hf_config(cls, hf_config) -> "Gemma2BlockConfig":
        def get(key):
            return getattr(hf_config, key, _HF_DEFAULTS[key])

        layer_types = get("layer_types")
        if not layer_types:
            # older configs: gemma-2's convention is sliding on even layers
            layer_types = tuple(
                "sliding_attention" if i % 2 == 0 else "full_attention" for i in range(get("num_hidden_layers"))
            )
        return cls(
            hidden_size=get("hidden_size"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads"),
            head_dim=get("head_dim") or get("hidden_size") // get("num_attention_heads"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            rms_norm_eps=get("rms_norm_eps"),
            rope_theta=get("rope_theta"),
            sliding_window=get("sliding_window"),
            layer_types=tuple(layer_types),
            attn_logit_softcapping=get("attn_logit_softcapping"),
            final_logit_softcapping=get("final_logit_softcapping"),
            query_pre_attn_scalar=float(get("query_pre_attn_scalar")),
            hidden_act="gelu_tanh",  # gemma-2's MLP is GeGLU with the tanh GeLU, whatever the config names
            vocab_size=get("vocab_size"),
            tie_word_embeddings=get("tie_word_embeddings"),
        )
