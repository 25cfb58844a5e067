"""Small shared helpers (petals_tpu/utils/misc.py), over torch dtypes."""

from __future__ import annotations

import numpy as np
import torch

# A dummy array stands for "no tensor here" inside fixed-arity RPC payloads
# (e.g. "no prompts for this chain").
DUMMY = np.empty(0, dtype=np.float32)
DUMMY_INT64 = np.empty(0, dtype=np.int64)


def is_dummy(array) -> bool:
    return getattr(array, "ndim", None) == 1 and array.shape[0] == 0


DTYPE_BYTES = {
    torch.float64: 8,
    torch.int64: 8,
    torch.float32: 4,
    torch.int32: 4,
    torch.bfloat16: 2,
    torch.float16: 2,
    torch.int16: 2,
    torch.int8: 1,
    torch.uint8: 1,
    torch.bool: 1,
}


def dtype_bytes(dtype) -> int:
    """Bytes per element of a torch or numpy dtype (or of an array's)."""
    if isinstance(dtype, (torch.Tensor, np.ndarray)):
        dtype = dtype.dtype
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


get_size_in_bytes = dtype_bytes
