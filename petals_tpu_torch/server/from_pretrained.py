"""Load one transformer block's weights from a checkpoint
(petals_tpu/server/from_pretrained.py): ``config.json`` plus
``*.safetensors``, sharded with a ``model.safetensors.index.json`` or as one
``model.safetensors``. Only the requested block's tensors are read. A name
that is not a local directory resolves through the streaming Hub fetcher
(utils/hub.py), from the endpoint ``hub_endpoint()`` names: config.json and
the shard index first, then only the shards that hold the requested
prefixes, into the flock'd LRU disk cache."""

from __future__ import annotations

import inspect
import json
import os
import types
from typing import Dict, Optional, Tuple

import torch

from petals_tpu_torch.constants import SAFE_INDEX, SAFE_SINGLE
from petals_tpu_torch.models.registry import ModelFamily, get_family
from petals_tpu_torch.utils import safetensors_io
from petals_tpu_torch.utils.device import resolve_device



def resolve_model_path(
    model_name_or_path: str,
    *,
    prefixes: Optional[tuple] = None,
    revision: str = "main",
    cache_dir=None,
    max_disk_space: Optional[int] = None,
) -> str:
    """A local directory as it is, else a Hub repo id fetched into the disk
    cache: config.json, and with ``prefixes`` the weight shards holding
    tensors under them. Returns a directory that reads like a (partial)
    local checkpoint."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path
    from petals_tpu_torch.utils import hub

    if prefixes is not None:
        return str(hub.ensure_weight_files(
            model_name_or_path, prefixes, revision=revision, cache_dir=cache_dir, max_disk_space=max_disk_space,
        ))
    return str(hub.ensure_config(
        model_name_or_path, revision=revision, cache_dir=cache_dir, max_disk_space=max_disk_space,
    ))


def load_hf_config(path: str, *, revision: str = "main", cache_dir=None) -> types.SimpleNamespace:
    """The checkpoint's config.json as an attribute namespace."""
    path = resolve_model_path(path, revision=revision, cache_dir=cache_dir)
    with open(os.path.join(path, "config.json")) as f:
        return types.SimpleNamespace(**json.load(f))


def get_block_config(path: str, *, revision: str = "main", cache_dir=None) -> Tuple[ModelFamily, object]:
    # the same revision and cache as the weights, or the shapes could differ
    hf_config = load_hf_config(path, revision=revision, cache_dir=cache_dir)
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
    revision: str = "main",
    cache_dir=None,
) -> Dict[str, torch.Tensor]:
    """Block ``block_index``'s parameter dict (weights [in, out]), floating
    tensors cast to ``dtype`` but for the family's ``cast_exempt`` leaves
    (gemma's float32 folded norms), on ``device`` (default: the CUDA card;
    the CPU only when asked for). A family whose blocks differ by index
    (gemma2's windows) gets ``block_index``, as petals_tpu's loader passes
    it; a non-tensor leaf (that window, a host int) stays as it is. A Hub
    repo id streams in exactly the shards that hold the block."""
    device = resolve_device(device)
    if family is None or cfg is None:
        family, cfg = get_block_config(path, revision=revision, cache_dir=cache_dir)
    prefixes = tuple(tpl.format(i=block_index) for tpl in family.hf_block_prefixes)
    path = resolve_model_path(path, prefixes=prefixes, revision=revision, cache_dir=cache_dir)
    tensors = load_tensors_with_prefixes(path, prefixes)
    if not tensors:
        raise KeyError(f"Block {block_index} not found in {path} under prefixes {list(prefixes)}")
    # moved first, so the [out, in] -> [in, out] transposes run on the device
    tensors = {k: t.to(device) for k, t in tensors.items()}
    if "block_index" in inspect.signature(family.hf_to_block_params).parameters:
        params = family.hf_to_block_params(tensors, cfg, block_index=block_index)
    else:
        params = family.hf_to_block_params(tensors, cfg)
    out = {}
    for name, t in params.items():
        if isinstance(t, torch.Tensor):
            keep = name in family.cast_exempt or not t.is_floating_point()
            t = t.to(dtype=t.dtype if keep else dtype).contiguous()
        out[name] = t
    return out
