"""The grouped matrix product of Mixtral's sparse experts: the wrapper of
the hand-written CUDA kernel (``csrc/grouped_matmul.cu``, K7) and its plain
PyTorch version.

``grouped_matmul(x, w, group_sizes)``: x [n, in] holds rows grouped by
expert (group e's ``group_sizes[e]`` rows after group e - 1's), w [E, in,
out]; row r of the output is ``x[r] @ w[e]`` for the group e it falls in,
summed in float32 and rounded once to x's dtype. It is the counterpart of
``jax.lax.ragged_dot`` in petals_tpu/models/mixtral/block.py ``_moe_sparse``,
which no Pallas kernel of the JAX package computes: K7 replaces no TPU
kernel. It exists because the alternatives on the card are worse: sizes
read to the host break the CUDA graph a mixed step replays, and running
every expert over every row makes prefill cost scale with E, not top-k.

The group sizes stay on the device: the kernel reads them there, so one
captured launch serves any routing. They must sum to n (the MoE glue counts
every assignment once); the plain version checks that, the kernel cannot
without a host sync. Tensors on the CPU go to the plain version; tensors on
a CUDA device launch the kernel or raise. There is no fallback from one to
the other. ``grouped_matmul.launches`` (a plain int) counts the kernel's
launches, ``grouped_matmul.arm_launches`` each arm's (telemetry/observatory.py
``count_launch``: a launch inside a capture is counted by each replay),
and each launch reports the work of the function it computes to a capture
that counts its cost (``count_cost``, ``grouped_matmul_cost``).

The kernel has two arms, chosen by x's dtype (``kernel_arm``): bfloat16 runs
``grouped_matmul_wgmma_kernel`` (wgmma fed by a TMA ring, 128-row tiles),
every served Mixtral prefill chunk; float32 runs ``grouped_matmul_kernel``
(CUDA-core FMAs, 64-row tiles), the references and float32 drafts, since
TF32 is not float32. ``grouped_tiles`` is the kernels' walk of the group
sizes on the host.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from petals_tpu_torch.telemetry.observatory import count_cost, count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the arm each dtype runs, and the rows of its tiles
ARMS = {torch.bfloat16: "wgmma", torch.float32: "cuda_cores"}
TILE_ROWS = {"wgmma": 128, "cuda_cores": 64}
_LIB: Optional[ctypes.CDLL] = None


def kernel_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    global _LIB
    if _LIB is None:
        from petals_tpu_torch.kernels.build import load

        lib = load("grouped_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_grouped_matmul.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.ptt_grouped_matmul.restype = i
        lib.ptt_grouped_error_string.argtypes = [i]
        lib.ptt_grouped_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def reset_launch_counts() -> None:
    """Zero the kernel's launch counters (K7: the total and each arm's)."""
    grouped_matmul.launches = 0
    grouped_matmul.arm_launches = {arm: 0 for arm in TILE_ROWS}


def grouped_matmul_cost(n_rows: int, k: int, n_out: int, n_experts: int, itemsize: int):
    """(flops, bytes, transcendentals) of one launch (K7) from its shapes
    alone, at capacity (telemetry/op_cost.py): each of the n rows through one
    expert's [k, n_out] weight, 2 * n * k * n_out flops whatever the
    routing; x read and the output written once, every expert's weight read
    once (the group sizes, on the card, may leave an expert empty), the
    group sizes read."""
    return 2 * n_rows * k * n_out, itemsize * (n_rows * k + n_experts * k * n_out + n_rows * n_out) + 4 * n_experts, 0


def kernel_arm(dtype: torch.dtype) -> str:
    """The arm of K7 that runs for x's dtype: "wgmma" for bfloat16 (tensor
    cores), "cuda_cores" for float32 (TF32 is not float32)."""
    if dtype not in ARMS:
        raise TypeError(f"the grouped matmul kernel takes float32 or bfloat16, got {dtype}")
    return ARMS[dtype]


def grouped_tiles(group_sizes: Sequence[int], bm: int) -> List[Optional[Tuple[int, int, int]]]:
    """The kernels' walk of the group sizes (csrc/grouped_matmul.cu
    ``tile_slot``): for each of the grid's ceil(n / bm) + E row-tile slots,
    in block order, the (expert, first row, rows) of its tile, or None for
    a slot past the last expert's tiles. Expert e's group gives
    ceil(size_e / bm) tiles of bm rows, the last one ragged."""
    sizes = [max(int(g), 0) for g in group_sizes]
    n = sum(sizes)
    tiles = []
    start = 0
    for e, size in enumerate(sizes):
        tiles += [(e, start + t * bm, min(bm, size - t * bm)) for t in range(-(-size // bm))]
        start += size
    n_slots = -(-n // bm) + len(sizes)
    return tiles + [None] * (n_slots - len(tiles))


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version: a loop over the experts on host-known group sizes,
    each group's product in float32, rounded once to x's dtype."""
    sizes = [int(n) for n in group_sizes.tolist()]
    if len(sizes) != w.shape[0] or min(sizes, default=0) < 0 or sum(sizes) != x.shape[0]:
        raise ValueError(f"group sizes {sizes} do not split {x.shape[0]} rows over {w.shape[0]} experts")
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(sizes):
        out[start : start + n] = (x[start : start + n].float() @ w[e].float()).to(x.dtype)
        start += n
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """x [n, in] (grouped by expert), w [E, in, out], group_sizes [E]
    (integers, on x's device) -> [n, out] in x's dtype (module docstring)."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1] or group_sizes.shape != (w.shape[0],):
        raise ValueError(f"grouped matmul of x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group sizes {tuple(group_sizes.shape)}")
    devices = {t.device for t in (x, w, group_sizes)}
    if all(dev.type == "cpu" for dev in devices):
        return grouped_matmul_reference(x, w, group_sizes)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the grouped matmul needs all tensors on one CUDA device, got {devices}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"the grouped matmul kernel takes float32 or bfloat16 x and w of one type, "
                        f"got {x.dtype} and {w.dtype}")
    n_rows, k = x.shape
    n_experts, _, n_out = w.shape
    per_16 = 16 // x.element_size()  # rows and columns are read 16 bytes at a time
    if k % per_16 or n_out % per_16:
        raise ValueError(f"in ({k}) and out ({n_out}) must be multiples of {per_16}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be contiguous and 16-byte aligned")
    arm = kernel_arm(x.dtype)
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((n_rows, n_out), dtype=x.dtype, device=x.device)
    if n_rows == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(x.device):
        err = lib.ptt_grouped_matmul(
            x.data_ptr(), w.data_ptr(), sizes.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], n_rows, k, n_out, n_experts,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        msg = lib.ptt_grouped_error_string(err).decode()
        raise RuntimeError(f"grouped matmul kernel launch failed: CUDA error {err} ({msg})")
    count_launch(grouped_matmul, "launches")
    count_launch(grouped_matmul, "arm_launches", arm)
    count_cost("grouped_matmul", grouped_matmul_cost, n_rows, k, n_out, n_experts, x.element_size())
    return out


reset_launch_counts()
