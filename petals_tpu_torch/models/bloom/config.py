"""BLOOM family block config (petals_tpu/models/bloom/config.py), read from
the checkpoint's config.json with HF BloomConfig's defaults where a key is
absent (``save_pretrained`` writes only what differs from them)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BloomBlockConfig:
    hidden_size: int
    num_attention_heads: int
    num_hidden_layers: int
    layer_norm_epsilon: float
    apply_residual_connection_post_layernorm: bool = False
    vocab_size: int = 250880
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_config(cls, hf_config) -> "BloomBlockConfig":
        """From a namespace of config.json (``n_embed`` is HF's older name
        of ``hidden_size``; ``n_head`` / ``n_layer`` are BloomConfig's own)."""
        hidden = getattr(hf_config, "hidden_size", None) or getattr(hf_config, "n_embed", None) or 64
        return cls(
            hidden_size=hidden,
            num_attention_heads=getattr(hf_config, "n_head", 8),
            num_hidden_layers=getattr(hf_config, "n_layer", 2),
            layer_norm_epsilon=getattr(hf_config, "layer_norm_epsilon", 1e-5),
            apply_residual_connection_post_layernorm=getattr(
                hf_config, "apply_residual_connection_post_layernorm", False
            ),
            vocab_size=getattr(hf_config, "vocab_size", 250880),
            tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", True),
        )
