"""Model-family registry: dispatch on the checkpoint's ``model_type``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

_FAMILIES: Dict[str, "ModelFamily"] = {}


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """What the server needs to load and run one model family's blocks, and
    what the client needs for its embeddings, final norm and head."""

    name: str  # HF model_type, e.g. "llama"
    config_from_hf: Callable[[Any], Any]  # config.json namespace -> block config
    block_apply: Callable  # (params, hidden, kv, position, cfg, ...) -> (hidden, kv)
    hf_block_prefixes: tuple  # checkpoint prefixes of block i, with {i} placeholder
    # (dict[str, Tensor], cfg) -> params dict; a family whose blocks differ
    # by index (gemma2's windows) also takes ``block_index``
    hf_to_block_params: Callable
    block_param_shapes: Callable  # (cfg, dtype) -> dict of meta tensors
    # the block architecture ("" -> same as name): families derived with
    # dataclasses.replace (mistral over llama) inherit it, so tables keyed
    # by architecture (utils/convert_block.py) resolve for them too
    block_arch: str = ""
    # whether sequence parallelism may serve the family (ring attention on
    # the stateless path, query sharding on the cached one): petals_tpu's
    # flag, True for llama, bloom, falcon, mixtral and the families derived
    # from llama; gemma2's softcap has no ring
    supports_ring_attention: bool = False
    # leaf NAMES whose loaded dtype the loaders keep through the cast to the
    # serving dtype (gemma's (1 + w)-folded norms stay float32: rounding
    # 1 + w to bf16 loses what the unfolded form keeps; rms_norm upcasts
    # anyway) and non-tensor leaves (gemma2's per-block window, a host int)
    cast_exempt: tuple = ()
    # client side (embeddings + final norm + LM head), filled by model.py
    # modules; server-only code never reads them
    hf_client_prefixes: tuple = ()  # checkpoint prefixes of client-held tensors
    hf_to_client_params: Optional[Callable] = None  # (dict of full names, cfg) -> params dict
    client_embed: Optional[Callable] = None  # (params, input_ids, cfg) -> hidden
    client_head: Optional[Callable] = None  # (params, hidden, cfg) -> float32 logits
    client_norm: Optional[Callable] = None  # (params, hidden, cfg) -> final-norm'd hidden
    # sequence classification (HF *ForSequenceClassification): embeddings,
    # final norm and the ``score`` head on the client
    hf_cls_prefixes: tuple = ()  # checkpoint prefixes with the score head
    hf_to_cls_params: Optional[Callable] = None  # (dict of full names, cfg) -> params dict
    cls_head: Optional[Callable] = None  # (params, hidden, cfg) -> float32 per-position label logits


def num_kv_heads(cfg) -> int:
    """The kv heads of a block config; a family without GQA (bloom) has no
    ``num_key_value_heads`` and keeps one a query head, as petals_tpu reads it."""
    return getattr(cfg, "num_key_value_heads", None) or cfg.num_attention_heads


def register_family(family: ModelFamily) -> ModelFamily:
    _FAMILIES[family.name] = family
    return family


def get_family(model_type: str) -> ModelFamily:
    import petals_tpu_torch.models  # noqa: F401  (registers the families)

    if model_type not in _FAMILIES:
        raise KeyError(f"Unsupported model family {model_type!r}; known: {sorted(_FAMILIES)}")
    return _FAMILIES[model_type]
