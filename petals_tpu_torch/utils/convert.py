"""Carry a block's parameters from numpy (as the JAX package's
``hf_to_block_params`` returns them: weights [in, out]) into the port's
tensors, keeping the layout. The tests feed both packages the same weights
through these."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """numpy -> tensor; a bfloat16 array (numpy extension dtype) keeps its bits.
    Floating arrays are cast to ``dtype``, others keep theirs."""
    arr = np.array(arr)  # a writable copy: arrays from JAX are read-only
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)


def block_params_from_numpy(
    params: Dict[str, np.ndarray], device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """One block's parameter dict."""
    return {name: tensor_from_numpy(arr, device, dtype) for name, arr in params.items()}


def stacked_from_numpy(
    blocks: Sequence[Dict[str, np.ndarray]], device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """A span: per-block parameter dicts stacked along a leading block axis
    (the layout ``TransformerBackend`` takes)."""
    return {
        name: torch.stack([tensor_from_numpy(b[name], device, dtype) for b in blocks])
        for name in blocks[0]
    }
