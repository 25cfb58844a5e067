"""Falcon family block config (petals_tpu/models/falcon/config.py), all
three generations: falcon-rw (MHA with ALiBi, serial attention, biases),
falcon-7b (multi-query, parallel attention) and falcon-40b/180b (the new
decoder architecture: GQA with dual LayerNorms). Read from a namespace of
config.json with HF FalconConfig's defaults where a key is absent
(``save_pretrained`` writes only what differs from them)."""

from __future__ import annotations

import dataclasses

# HF FalconConfig's defaults (transformers' configuration_falcon.py)
_HF_DEFAULTS = dict(
    vocab_size=65024, hidden_size=4544, num_hidden_layers=32, num_attention_heads=71,
    layer_norm_epsilon=1e-5, num_kv_heads=None, alibi=False, new_decoder_architecture=False,
    multi_query=True, parallel_attn=True, bias=False, num_ln_in_parallel_attn=None,
    rope_theta=10000.0, activation="gelu", ffn_hidden_size=None, tie_word_embeddings=True,
)


@dataclasses.dataclass(frozen=True)
class FalconBlockConfig:
    hidden_size: int
    num_attention_heads: int
    num_kv_heads: int  # effective kv heads after the arch rules
    num_hidden_layers: int
    layer_norm_epsilon: float
    ffn_hidden_size: int
    new_decoder_architecture: bool = False
    parallel_attn: bool = True
    num_ln_in_parallel_attn: int = 2
    multi_query: bool = True
    alibi: bool = False
    bias: bool = False
    rope_theta: float = 10000.0
    activation: str = "gelu"
    vocab_size: int = 65024
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_heads(self) -> int:
        return self.num_kv_heads

    @classmethod
    def from_hf_config(cls, hf_config) -> "FalconBlockConfig":
        def get(key):
            return getattr(hf_config, key, _HF_DEFAULTS[key])

        hidden = getattr(hf_config, "hidden_size", None) or getattr(hf_config, "n_embed", None) or _HF_DEFAULTS["hidden_size"]
        heads = get("num_attention_heads")
        new_arch, multi_query = get("new_decoder_architecture"), get("multi_query")
        if new_arch:
            num_kv = get("num_kv_heads") or heads
        elif multi_query:
            num_kv = 1
        else:
            num_kv = heads
        num_ln = get("num_ln_in_parallel_attn")
        if num_ln is None:
            num_ln = 2 if new_arch else 1
        return cls(
            hidden_size=hidden,
            num_attention_heads=heads,
            num_kv_heads=num_kv,
            num_hidden_layers=get("num_hidden_layers"),
            layer_norm_epsilon=get("layer_norm_epsilon"),
            ffn_hidden_size=get("ffn_hidden_size") or 4 * hidden,
            new_decoder_architecture=new_arch,
            parallel_attn=get("parallel_attn"),
            num_ln_in_parallel_attn=num_ln,
            multi_query=multi_query,
            alibi=get("alibi"),
            bias=get("bias"),
            rope_theta=get("rope_theta"),
            activation=get("activation"),
            vocab_size=get("vocab_size"),
            tie_word_embeddings=get("tie_word_embeddings"),
        )
