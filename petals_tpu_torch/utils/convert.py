"""Carry a block's parameters from numpy (as the JAX package's
``hf_to_block_params`` returns them: weights [in, out]) into the port's
tensors, keeping the layout. A quantized weight crosses as its numpy pieces
(``quant_leaf_from_numpy``) and rides beside the dense arrays. The JAX
client's embeddings, norm and head cross through
``client_params_from_numpy``. The tests feed both packages the same weights
through these."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, OutlierQuantLinear, QuantizedLinear


def tensor_from_numpy(arr: np.ndarray, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """numpy -> tensor; a bfloat16 array (numpy extension dtype) keeps its bits.
    Floating arrays are cast to ``dtype`` (``None``: kept), others keep theirs."""
    arr = np.array(arr)  # a writable copy: arrays from JAX are read-only
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype if dtype is not None and t.is_floating_point() else t.dtype)


def quant_leaf_from_numpy(
    kind: str,
    data: np.ndarray,
    scales: np.ndarray,
    in_features: int,
    out_features: int,
    idx: Optional[np.ndarray] = None,
    w_out: Optional[np.ndarray] = None,
    device="cpu",
):
    """A port QuantizedLinear from its stored pieces (``kind`` of a ``+o``
    kind names the outlier form, which also takes ``idx`` and ``w_out``).
    Every piece keeps its dtype and bits."""

    def keep(arr):
        return tensor_from_numpy(arr, device, None)

    base = kind[:-2] if kind.endswith("+o") else kind
    inner = QuantizedLinear(base, keep(data), keep(scales), int(in_features), int(out_features))
    if base == kind:
        return inner
    return OutlierQuantLinear(inner, keep(idx), keep(w_out))


def _leaf_to(leaf, device, dtype: Optional[torch.dtype]):
    if isinstance(leaf, QUANTIZED_TYPES):
        return leaf.to(device)
    arr = np.asarray(leaf)
    if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
        # an int32 scalar leaf (gemma2's per-block window) is a host int in
        # the port: each block's launches bake it in, never a read on the card
        return int(arr)
    return tensor_from_numpy(leaf, device, dtype)


def block_params_from_numpy(params: Dict[str, object], device, dtype: torch.dtype, family=None) -> Dict[str, object]:
    """One block's parameter dict: numpy arrays (floating ones cast to
    ``dtype``, but for the ``family``'s cast-exempt leaves, which keep
    theirs: gemma's float32 folded norms), port quantized leaves (moved to
    ``device`` as they are) and integer scalars as host ints."""
    exempt = family.cast_exempt if family is not None else ()
    return {name: _leaf_to(leaf, device, None if name in exempt else dtype) for name, leaf in params.items()}


def _stack(leaves):
    first = leaves[0]
    if isinstance(first, int):  # host-int leaves: one a block
        return list(leaves)
    if isinstance(first, OutlierQuantLinear):
        return OutlierQuantLinear(
            _stack([leaf.inner for leaf in leaves]),
            torch.stack([leaf.idx for leaf in leaves]), torch.stack([leaf.w_out for leaf in leaves]),
        )
    if isinstance(first, QuantizedLinear):
        return QuantizedLinear(
            first.kind, torch.stack([leaf.data for leaf in leaves]),
            torch.stack([leaf.scales for leaf in leaves]), first.in_features, first.out_features,
        )
    return torch.stack(leaves)


def stacked_from_numpy(blocks: Sequence[Dict[str, object]], device, dtype: torch.dtype,
                       family=None) -> Dict[str, object]:
    """A span: per-block parameter dicts stacked along a leading block axis
    (the layout ``TransformerBackend`` takes); a quantized leaf stacks its
    pieces, a host-int leaf is a list of them; ``family``'s cast-exempt
    leaves keep their dtype (``block_params_from_numpy``)."""
    exempt = family.cast_exempt if family is not None else ()
    return {name: _stack([_leaf_to(b[name], device, None if name in exempt else dtype) for b in blocks])
            for name in blocks[0]}


def dense_cache_from_numpy(kv, device, dtype: Optional[torch.dtype] = None):
    """A dense cache pair ``(k_stack, v_stack)``, each [n_blocks, batch,
    max_length, hkv, d], from numpy into the port's tensors. Every array is
    COPIED (``tensor_from_numpy``): ``np.asarray`` of a JAX array can share
    its buffer, and the port's steps write caches in place. Deep prompts
    [n_blocks, batch, pre_seq, hidden] cross through ``tensor_from_numpy``
    the same way."""
    k_stack, v_stack = kv
    return tensor_from_numpy(k_stack, device, dtype), tensor_from_numpy(v_stack, device, dtype)


def client_params_from_numpy(params: Dict[str, np.ndarray], device, dtype: torch.dtype = torch.float32,
                             family=None) -> Dict[str, torch.Tensor]:
    """The JAX client's parameters (``{"embed", "norm", "head"}`` numpy
    arrays, the head [hidden, vocab]) as the port client holds them: floating
    leaves in ``dtype`` but for ``family``'s cast-exempt ones, the head in
    float32 (client/from_pretrained.py)."""
    from petals_tpu_torch.client.from_pretrained import cast_client_params

    return cast_client_params({name: tensor_from_numpy(arr, "cpu", None) for name, arr in params.items()}, device,
                              dtype, family)
