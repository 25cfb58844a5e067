"""Reader and writer of the safetensors format: an 8-byte little-endian
header length, a JSON header mapping tensor names to dtype, shape and byte
offsets (plus an optional ``__metadata__`` entry), then the raw little-endian
bytes of every tensor."""

from __future__ import annotations

import json
import struct
from typing import Callable, Dict, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_CODES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 << 20


def read_header(path: str) -> tuple:
    """(header dict without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: safetensors header of {n} bytes is implausible")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(
    path: str, select: Optional[Callable[[str], bool]] = None
) -> Dict[str, torch.Tensor]:
    """Read the tensors of ``path`` (those whose name ``select`` accepts) into
    CPU tensors."""
    header, data_start = read_header(path)
    out = {}
    with open(path, "rb") as f:
        for name, info in header.items():
            if select is not None and not select(name):
                continue
            begin, end = info["data_offsets"]
            dtype = DTYPES[info["dtype"]]
            shape = tuple(info["shape"])
            f.seek(data_start + begin)
            buf = bytearray(f.read(end - begin))
            numel = 1
            for s in shape:
                numel *= s
            if len(buf) != numel * dtype.itemsize:
                raise ValueError(f"{path}: {name} holds {len(buf)} bytes for shape {shape}")
            tensor = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
            out[name] = tensor.view(dtype).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str, metadata: Optional[dict] = None) -> None:
    """Write ``tensors`` (any device; copied to the CPU) to ``path``."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {
            "dtype": _CODES[t.dtype], "shape": list(t.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        offset += len(raw)
        blobs.append(raw)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
