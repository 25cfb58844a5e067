"""Tensor (de)serialization for the wire, byte-compatible with
petals_tpu/rpc/serialization.py: a msgpack-safe dict {shape, dtype,
wire_dtype, compression, data}. Compressions:

- ``none``:     raw little-endian bytes of the original dtype
- ``float16``:  float tensors cast to fp16 on the wire
- ``bfloat16``: float tensors cast to bf16 on the wire
- ``qint8``:    blockwise absmax int8 of float tensors: one float32 scale
                per block of 1024 elements (``scales``), codes as int8

Host-side tensors are CPU ``torch.Tensor``s (numpy has no bfloat16); bf16
bytes travel as the tensor viewed as 16-bit integers.

The qint8 arithmetic is that of petals_tpu's C++ codec
(petals_tpu/native/qint8.cpp, which petals_tpu uses wherever g++ built
it), vectorized in numpy, every step in float32: a block's scale is
``max(|x|, 1e-8)`` (NaNs ignored, as its loop ignores them), its codes
``nearbyint(x * (127 / scale))`` clipped to +-127, and decoding is
``q * (scale / 127)``. petals_tpu's numpy fallback divides instead
(``x / scale * 127``, ``(q / 127) * scale``) and can differ from the C++
codec in the last bit, so it is not what this copies.
"""

from __future__ import annotations

import enum
from typing import Any, Dict

import numpy as np
import torch

from petals_tpu_torch.utils.misc import is_dummy  # noqa: F401 (the wire's placeholder test)

_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


_QBLOCK = 1024  # qint8 elements a scale


class CompressionType(str, enum.Enum):
    NONE = "none"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    QINT8 = "qint8"


def as_tensor(array) -> torch.Tensor:
    """numpy array or tensor -> contiguous CPU tensor."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(array))


def serialize_array(array, compression: CompressionType = CompressionType.NONE) -> Dict[str, Any]:
    t = as_tensor(array)
    compression = CompressionType(compression)
    if compression == CompressionType.QINT8 and t.is_floating_point():
        return _serialize_qint8(t)
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
    if compression == CompressionType.QINT8:
        return _deserialize_qint8(obj, shape, target)
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


def qint8_quantize(flat: np.ndarray):
    """float32 [n] -> (codes int8 [n], scales float32 [ceil(n / 1024)])."""
    n = flat.size
    n_blocks = -(-n // _QBLOCK)
    padded = np.zeros(n_blocks * _QBLOCK, np.float32)
    padded[:n] = flat
    blocks = padded.reshape(n_blocks, _QBLOCK)
    # fmax skips NaN, as the C++ loop's comparison does; the zero padding
    # never exceeds the floor
    scales = np.fmax(np.fmax.reduce(np.abs(blocks), axis=1), np.float32(1e-8)).astype(np.float32)
    inv = np.float32(127.0) / scales
    codes = np.clip(np.rint(blocks * inv[:, None]), -127, 127).astype(np.int8)
    return codes.reshape(-1)[:n], scales


def qint8_dequantize(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """(codes int8 [n], scales float32 [blocks]) -> float32 [n]."""
    n = codes.size
    step = scales / np.float32(127.0)
    return codes.astype(np.float32) * np.repeat(step, _QBLOCK)[:n]


def _serialize_qint8(t: torch.Tensor) -> Dict[str, Any]:
    codes, scales = qint8_quantize(t.reshape(-1).to(torch.float32).numpy())
    return {
        "shape": list(t.shape),
        "dtype": _NAMES[t.dtype],
        "wire_dtype": "int8",
        "compression": CompressionType.QINT8.value,
        "data": codes.tobytes(),
        "scales": scales.tobytes(),
    }


def _deserialize_qint8(obj: Dict[str, Any], shape: tuple, target: torch.dtype) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    n_blocks = -(-n // _QBLOCK)
    data, scales_bytes = obj["data"], obj.get("scales", b"")
    # untrusted lengths, checked as petals_tpu checks them: every block
    # needs its scale, every element its code
    if len(data) < n:
        raise ValueError(f"qint8 data too short: {len(data)} bytes for {n} elements")
    if len(scales_bytes) != n_blocks * 4:
        raise ValueError(
            f"qint8 scales length {len(scales_bytes)} != {n_blocks * 4} "
            f"(need {n_blocks} f32 scales for {n} elements)"
        )
    codes = np.frombuffer(bytearray(data), dtype=np.int8)[:n]
    scales = np.frombuffer(bytearray(scales_bytes), dtype=np.float32)
    return torch.from_numpy(qint8_dequantize(codes, scales)).reshape(shape).to(target)


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} is not supported on the wire by this server")
    return _DTYPES[name]


