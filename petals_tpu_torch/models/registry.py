"""Model-family registry: dispatch on the checkpoint's ``model_type``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

_FAMILIES: Dict[str, "ModelFamily"] = {}


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """What the server needs to load and run one model family's blocks."""

    name: str  # HF model_type, e.g. "llama"
    config_from_hf: Callable[[Any], Any]  # config.json namespace -> block config
    block_apply: Callable  # (params, hidden, kv, position, cfg, ...) -> (hidden, kv)
    hf_block_prefixes: tuple  # checkpoint prefixes of block i, with {i} placeholder
    hf_to_block_params: Callable  # (dict[str, Tensor], cfg) -> params dict
    block_param_shapes: Callable  # (cfg, dtype) -> dict of meta tensors


def register_family(family: ModelFamily) -> ModelFamily:
    _FAMILIES[family.name] = family
    return family


def get_family(model_type: str) -> ModelFamily:
    import petals_tpu_torch.models  # noqa: F401  (registers the families)

    if model_type not in _FAMILIES:
        raise KeyError(f"Unsupported model family {model_type!r}; known: {sorted(_FAMILIES)}")
    return _FAMILIES[model_type]
