"""Llama family block config (the fields of petals_tpu/models/llama/config.py
that the llama, mistral, qwen2, gemma and phi3 families use)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# HF activation names -> models/common.py ACTIVATIONS (petals_tpu's table:
# gemma's checkpoints name the tanh GeLU gelu_pytorch_tanh, gemma-7b's
# config.json says gelu, read as the exact GeLU, as petals_tpu reads it)
_HF_ACT_NAMES = {"silu": "silu", "gelu_pytorch_tanh": "gelu_tanh", "gelu": "gelu"}


@dataclasses.dataclass(frozen=True)
class LlamaBlockConfig:
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    num_hidden_layers: int
    rms_norm_eps: float
    rope_theta: float = 10000.0
    # rope_scaling as a hashable tuple of (key, value) pairs, or None
    rope_scaling: Optional[Tuple[Tuple[str, object], ...]] = None
    attention_bias: bool = False  # bias on q, k, v AND o (HF llama convention)
    qkv_bias: bool = False  # bias on q, k, v only (HF qwen2 convention)
    mlp_bias: bool = False
    # all-layer sliding window (HF mistral convention); None = full attention
    sliding_window: Optional[int] = None
    # MLP activation by name (models/common.py ACTIVATIONS): silu, or gemma's
    # tanh-approximate / exact GeLU
    hidden_act: str = "silu"
    vocab_size: int = 32000
    tie_word_embeddings: bool = False

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling is not None else None

    @classmethod
    def from_hf_config(cls, hf_config) -> "LlamaBlockConfig":
        """From a namespace of the checkpoint's config.json."""
        rope_scaling = getattr(hf_config, "rope_scaling", None)
        if rope_scaling is not None:
            rope_scaling = tuple(sorted(rope_scaling.items()))
        head_dim = getattr(hf_config, "head_dim", None) or (
            hf_config.hidden_size // hf_config.num_attention_heads
        )
        act = getattr(hf_config, "hidden_act", "silu")
        if act not in _HF_ACT_NAMES:
            raise NotImplementedError(f"hidden_act {act!r} is not in models/common.py ACTIVATIONS")
        return cls(
            hidden_size=hf_config.hidden_size,
            num_attention_heads=hf_config.num_attention_heads,
            num_key_value_heads=getattr(hf_config, "num_key_value_heads", None)
            or hf_config.num_attention_heads,
            head_dim=head_dim,
            intermediate_size=hf_config.intermediate_size,
            num_hidden_layers=hf_config.num_hidden_layers,
            rms_norm_eps=hf_config.rms_norm_eps,
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            attention_bias=getattr(hf_config, "attention_bias", False),
            mlp_bias=getattr(hf_config, "mlp_bias", False),
            hidden_act=_HF_ACT_NAMES[act],
            vocab_size=hf_config.vocab_size,
            tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        )
