"""Load one transformer block's weights from a local checkpoint directory
(petals_tpu/server/from_pretrained.py for local paths): ``config.json`` plus
``*.safetensors``, sharded with a ``model.safetensors.index.json`` or as one
``model.safetensors``. Only the requested block's tensors are read."""

from __future__ import annotations

import json
import os
import types
from typing import Dict, Optional, Tuple

import torch

from petals_tpu_torch.models.registry import ModelFamily, get_family
from petals_tpu_torch.utils import safetensors_io
from petals_tpu_torch.utils.device import resolve_device

SAFE_INDEX = "model.safetensors.index.json"
SAFE_SINGLE = "model.safetensors"


def load_hf_config(path: str) -> types.SimpleNamespace:
    """The checkpoint's config.json as an attribute namespace."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path} is not a local checkpoint directory")
    with open(os.path.join(path, "config.json")) as f:
        return types.SimpleNamespace(**json.load(f))


def get_block_config(path: str) -> Tuple[ModelFamily, object]:
    hf_config = load_hf_config(path)
    family = get_family(hf_config.model_type)
    return family, family.config_from_hf(hf_config)


def _index_weight_files(path: str) -> Dict[str, str]:
    """{tensor_name: filename}, or {"*": filename} for a single file."""
    index_file = os.path.join(path, SAFE_INDEX)
    if os.path.exists(index_file):
        with open(index_file) as f:
            return json.load(f)["weight_map"]
    if os.path.exists(os.path.join(path, SAFE_SINGLE)):
        return {"*": SAFE_SINGLE}
    raise FileNotFoundError(f"No safetensors weights in {path}")


def load_tensors_with_prefixes(path: str, prefixes: tuple, *, keep_full_names: bool = False) -> Dict[str, torch.Tensor]:
    """CPU tensors whose name starts with one of ``prefixes``, keyed by the
    name relative to that prefix (``keep_full_names``: by the full name, as
    the client's mappings read them); each weight file is read at most once."""
    weight_map = _index_weight_files(path)

    def match(name: str) -> Optional[str]:
        for prefix in prefixes:
            if name.startswith(prefix):
                return name[len(prefix):]
        return None

    if "*" in weight_map:
        files = {weight_map["*"]}
    else:
        files = {fname for name, fname in weight_map.items() if match(name) is not None}
    out: Dict[str, torch.Tensor] = {}
    for fname in sorted(files):
        tensors = safetensors_io.load_file(
            os.path.join(path, fname), select=lambda name: match(name) is not None
        )
        for name, tensor in tensors.items():
            out[name if keep_full_names else match(name)] = tensor
    return out


def load_block_params(
    path: str,
    block_index: int,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    family: Optional[ModelFamily] = None,
    cfg=None,
) -> Dict[str, torch.Tensor]:
    """Block ``block_index``'s parameter dict (weights [in, out]), floating
    tensors cast to ``dtype``, on ``device`` (default: the CUDA card; the
    CPU only when asked for)."""
    device = resolve_device(device)
    if family is None or cfg is None:
        family, cfg = get_block_config(path)
    prefixes = tuple(tpl.format(i=block_index) for tpl in family.hf_block_prefixes)
    tensors = load_tensors_with_prefixes(path, prefixes)
    if not tensors:
        raise KeyError(f"Block {block_index} not found in {path} under prefixes {list(prefixes)}")
    # moved first, so the [out, in] -> [in, out] transposes run on the device
    params = family.hf_to_block_params({k: t.to(device) for k, t in tensors.items()}, cfg)
    return {
        name: t.to(dtype=dtype if t.is_floating_point() else t.dtype).contiguous()
        for name, t in params.items()
    }
