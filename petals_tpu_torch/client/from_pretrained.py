"""The client's weights: embeddings, final norm and head only
(petals_tpu/client/from_pretrained.py:19-36), read from a local checkpoint
through the server's loader; no ``model.layers.*`` tensor is read."""

from __future__ import annotations

import torch

from petals_tpu_torch.server.from_pretrained import get_block_config, load_tensors_with_prefixes
from petals_tpu_torch.utils.device import resolve_device


def cast_client_params(params: dict, device, dtype: torch.dtype) -> dict:
    """Floating leaves cast to the client's ``dtype`` on ``device``. The head
    is then held in float32 whatever ``dtype`` is (the float32 of the
    ``dtype``-rounded values, as petals_tpu's head computes in float32), so
    no call casts it; a tied head stays a view of the embeddings when that
    is already float32."""
    out = {
        name: t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
        for name, t in params.items()
        if name != "head"
    }
    head = params.get("head")
    if head is not None:
        embed = params.get("embed")
        if embed is not None and head.data_ptr() == embed.data_ptr() and dtype == torch.float32:
            out["head"] = out["embed"].t()  # tied: one copy of the matrix on the device
        else:
            out["head"] = head.to(device=device, dtype=dtype).float()
    return out


def load_client_params(path: str, *, dtype: torch.dtype = torch.float32, device=None, family=None, cfg=None) -> dict:
    """The client-held parameters of a local checkpoint, floating leaves in
    ``dtype`` (default float32, as petals_tpu's client), on ``device``
    (default: the CUDA card; the CPU only when asked for)."""
    device = resolve_device(device)
    if family is None or cfg is None:
        family, cfg = get_block_config(path)
    if family.hf_to_client_params is None:
        raise NotImplementedError(f"{family.name} has no client mapping")
    tensors = load_tensors_with_prefixes(path, family.hf_client_prefixes, keep_full_names=True)
    return cast_client_params(family.hf_to_client_params(tensors, cfg), device, dtype)
