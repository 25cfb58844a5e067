"""Tensor (de)serialization for the wire, byte-compatible with
petals_tpu/rpc/serialization.py: a msgpack-safe dict {shape, dtype,
wire_dtype, compression, data}. Compressions:

- ``none``:     raw little-endian bytes of the original dtype
- ``float16``:  float tensors cast to fp16 on the wire
- ``bfloat16``: float tensors cast to bf16 on the wire

Host-side tensors are CPU ``torch.Tensor``s (numpy has no bfloat16); bf16
bytes travel as the tensor viewed as 16-bit integers.
"""

from __future__ import annotations

import enum
from typing import Any, Dict

import numpy as np
import torch

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CompressionType(str, enum.Enum):
    NONE = "none"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"


def as_tensor(array) -> torch.Tensor:
    """numpy array or tensor -> contiguous CPU tensor."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(array))


def serialize_array(array, compression: CompressionType = CompressionType.NONE) -> Dict[str, Any]:
    t = as_tensor(array)
    compression = CompressionType(compression)
    if compression == CompressionType.FLOAT16 and t.is_floating_point():
        data = t.to(torch.float16)
    elif compression == CompressionType.BFLOAT16 and t.is_floating_point():
        data = t.to(torch.bfloat16)
    else:
        compression, data = CompressionType.NONE, t
    return {
        "shape": list(t.shape),
        "dtype": _NAMES[t.dtype],
        "wire_dtype": _NAMES[data.dtype],
        "compression": compression.value,
        "data": data.reshape(-1).view(torch.uint8).numpy().tobytes(),
    }


def deserialize_array(obj: Dict[str, Any]) -> torch.Tensor:
    """Wire dict -> CPU tensor of the original dtype. Wire input is
    untrusted: names, compression and byte counts are validated."""
    compression = CompressionType(obj.get("compression", "none"))
    shape = tuple(int(s) for s in obj["shape"])
    target = _dtype(obj["dtype"])
    wire = _dtype(obj.get("wire_dtype", obj["dtype"]))
    if compression != CompressionType.NONE and wire != _dtype(compression.value):
        raise ValueError(f"{compression.value} compression with wire dtype {_NAMES[wire]}")
    data = obj["data"]
    numel = int(np.prod(shape)) if shape else 1
    if len(data) != numel * wire.itemsize:
        raise ValueError(f"{len(data)} bytes do not hold {shape} of {_NAMES[wire]}")
    raw = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
    t = raw.view(wire).reshape(shape)
    return t if wire == target else t.to(target)


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not supported on the wire by this server")
    return _DTYPES[name]


def is_dummy(t) -> bool:
    """A 1-D empty tensor stands for "no tensor here" in fixed-arity payloads."""
    return t.dim() == 1 and t.shape[0] == 0
