"""The devices of a tensor-parallel span (petals_tpu/parallel/mesh.py's
``tp_mesh`` / ``make_mesh``). Where the JAX package lays a 1-D ("tp",) mesh
over its host's chips and lets XLA insert the collectives, the port keeps a
plain list of devices: shard i of every weight and of every KV buffer lies
on entry i, and one process drives them all. A device may be listed more
than once: two shards on one card run the whole tensor-parallel path on a
single GPU."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch


def tp_devices(
    num_devices: Optional[int] = None,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> List[torch.device]:
    """``num_devices`` devices for the shards of a span: the first of
    ``devices`` (default: every visible CUDA device, in order). ``None``
    takes them all. Raises ValueError when too few are listed, as
    ``make_mesh`` does."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices) if num_devices is None else int(num_devices)
    if n < 1:
        raise ValueError(f"num_devices must be >= 1, got {n}")
    if n > len(devices):
        raise ValueError(f"Mesh of {(n,)} needs {n} devices, have {len(devices)}")
    out = devices[:n]
    for d in out:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass CPU devices to run on the CPU explicitly")
    return [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in out]
