"""Pack/unpack arbitrary (args, kwargs) pytrees of arrays for the wire
(petals_tpu/utils/packaging.py), with torch tensors as the arrays.

``pack_args_kwargs`` separates the arrays (sent as tensors) from the static
structure (a msgpack-safe skeleton — no pickle, peers are untrusted);
``unpack_args_kwargs`` reassembles them.

Supported containers: list/tuple/dict with string keys. Supported static
leaves: None/bool/int/float/str/bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

_TENSOR_KEY = "__tensor__"
_TUPLE_KEY = "__tuple__"


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _build_skeleton(obj: Any, arrays: List[Any]) -> Any:
    if _is_array(obj):
        arrays.append(obj)
        return {_TENSOR_KEY: len(arrays) - 1}
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [_build_skeleton(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return [_build_skeleton(v, arrays) for v in obj]
    if isinstance(obj, dict):
        if _TENSOR_KEY in obj or _TUPLE_KEY in obj:
            raise ValueError(f"Dict keys {_TENSOR_KEY}/{_TUPLE_KEY} are reserved")
        return {str(k): _build_skeleton(v, arrays) for k, v in obj.items()}
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    raise TypeError(f"Cannot pack object of type {type(obj)} for the wire: {obj!r}")


def _fill_skeleton(skel: Any, arrays: Sequence[Any]) -> Any:
    if isinstance(skel, dict):
        if _TENSOR_KEY in skel:
            return arrays[skel[_TENSOR_KEY]]
        if _TUPLE_KEY in skel:
            return tuple(_fill_skeleton(v, arrays) for v in skel[_TUPLE_KEY])
        return {k: _fill_skeleton(v, arrays) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_fill_skeleton(v, arrays) for v in skel]
    return skel


def pack_args_kwargs(*args, **kwargs) -> Tuple[List[Any], Dict]:
    """Flatten args/kwargs into (list_of_arrays, msgpack-safe structure)."""
    arrays: List[Any] = []
    skeleton = _build_skeleton((args, kwargs), arrays)
    return arrays, {"skeleton": skeleton, "n_tensors": len(arrays)}


def unpack_args_kwargs(arrays: Sequence[Any], structure: Dict) -> Tuple[tuple, dict]:
    n_expected = structure.get("n_tensors")
    if n_expected is not None and n_expected != len(arrays):
        raise ValueError(f"Expected {n_expected} arrays, got {len(arrays)}")
    args, kwargs = _fill_skeleton(structure["skeleton"], arrays)
    return args, kwargs
