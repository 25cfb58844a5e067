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


def serving_devices(
    num_tp: int = 1,
    num_sp: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> List[torch.device]:
    """The devices of a tp x sp serving grid (petals_tpu's ``serving_mesh``):
    the first ``num_tp * num_sp`` of ``devices`` in ``make_mesh``'s order,
    the (tp, sp) grid flattened row by row, so entry ``t * num_sp + s`` holds
    tp shard t of sp rank s. Heads and FFN columns split over tp; the
    parameters and the dense KV cache are replicated over sp. Refuses too
    few devices as ``make_mesh`` does."""
    num_tp, num_sp = int(num_tp), int(num_sp)
    if num_tp < 1 or num_sp < 1:
        raise ValueError(f"num_tp and num_sp must be >= 1, got {num_tp} x {num_sp}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = num_tp * num_sp
    if n > len(devices):
        raise ValueError(f"Mesh of {(num_tp, num_sp)} needs {n} devices, have {len(devices)}")
    return tp_devices(n, devices)
