"""Wrappers of the hand-written CUDA dequant-matmul kernels
(``csrc/quant_matmul.cu``) and the dispatch ``quant_matmul`` sends a
quantized weight to.

- ``quant_decode_matmul``: M <= 32 rows (``_NF4_DECODE_MAX_M``): K5's decode
  kernel for nf4/nf4a/int4, K6 for int8; at most one block per SM streams
  an equal share of the weight through a TMA ring, and a column slab cut
  between blocks is merged inside the same launch (``decode_plan``).
- ``quant_prefill_matmul``: M > 32 rows: K5's prefill kernel for
  nf4/nf4a/int4, K6 for int8; wgmma products on weight tiles decoded to
  bf16 in shared memory while the tensor cores run, tiled and split by
  ``prefill_plan``.

Each takes x [M, in] and a ``QuantizedLinear``, casts x to bf16 and returns
x's dtype. Tensors on the CPU go to the plain version
(ops/quant.py ``dequant_matmul_reference``); tensors on a CUDA device launch
the kernel or raise. There is no fallback from one to the other. Each
wrapper counts its launches per weight kind in ``<wrapper>.launches`` (a
dict of ints), so a run can show that its main path went through the
kernels; a launch inside a CUDA graph capture is counted by each replay of
the graph instead (telemetry/observatory.py ``count_launch``), and reports
the work of the function it computes to a capture that counts its cost
(``count_cost``, ``quant_matmul_cost``).

The kernels replace ``_packed4_decode_kernel``, ``_packed4_kernel`` and
``_int8_kernel`` of petals_tpu/ops/quant.py; the source says what bounds
them and how their design answers that.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from petals_tpu_torch.ops.paged_flash_attention import merge_tickets
from petals_tpu_torch.ops.quant import NF4_BLOCK, QuantizedLinear, dequant_matmul_reference
from petals_tpu_torch.telemetry.observatory import count_cost, count_launch

_NF4_DECODE_MAX_M = 32  # the decode/prefill split, as in the JAX package
_FORMAT_CODES = {"nf4": 0, "nf4a": 1, "int4": 2, "int8": 3}
_DEC_SLAB = 256  # columns of a decode work unit (one unit: a slab by one scale block)
_DEC_RING_BYTES = 64 * 1024  # weight bytes a decode block keeps in flight, at least
_DEC_ALIGNED_FILL = 0.8  # the share of SMs a slab-aligned decode grid must fill to be taken
_PF_BN = 128  # columns per prefill tile
_PF_SUB_M = 64  # rows per warpgroup sub-tile of the prefill kernel
_PF_MIN_KB_PER_SPLIT = 4  # scale blocks each prefill K split takes at least
_LIB: Optional[ctypes.CDLL] = None


def kernel_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernels' library."""
    global _LIB
    if _LIB is None:
        from petals_tpu_torch.kernels.build import load

        lib = load("quant_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_quant_matmul_decode.argtypes = [i] + [p] * 6 + [i] * 5 + [p]
        lib.ptt_quant_matmul_decode.restype = i
        lib.ptt_quant_matmul_prefill.argtypes = [i] + [p] * 5 + [i] * 6 + [p]
        lib.ptt_quant_matmul_prefill.restype = i
        lib.ptt_quant_error_string.argtypes = [i]
        lib.ptt_quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


class DecodePlan(NamedTuple):
    """The decode kernel's schedule: the weight's columns in ``n_slabs``
    slabs of 256, K in ``n_kb`` scale blocks of 64 rows; a unit is one
    (slab, scale block), numbered slab-major; ``ctas`` blocks (at most one
    per SM) each take an equal contiguous run of the units
    (``decode_segments``); each block's producer feeds two rings of
    ``stages`` units (one per consumer parity); ``row_tiles`` 8-row tiles of
    x (1 to 4) per product."""

    n_slabs: int
    n_kb: int
    ctas: int
    stages: int
    row_tiles: int


def decode_plan(m: int, in_features: int, out_features: int, n_sm: int, kind: str = "nf4a") -> DecodePlan:
    """The decode kernel's plan for x [m <= 32, in] @ w [in, out] of
    ``kind`` on a card of ``n_sm`` SMs. The blocks: a multiple of the slab
    count, ``n_slabs * (n_sm // n_slabs)``, when that fills at least
    ``_DEC_ALIGNED_FILL`` of the SMs: every block's run then lies in one
    slab, so a block leaves at most one partial to merge (none when it holds
    the whole slab); else one block per SM, whose runs may cut two slabs
    each (stream-K). Either way every block streams the same share of the
    weight (fewer blocks only when there are fewer units). Two rings of 2
    to 4 stages holding at least ``_DEC_RING_BYTES`` of weight bytes
    together (a stage of int8 is twice a 4-bit one). Pure: the same
    arguments give the same plan."""
    if not 1 <= m <= _NF4_DECODE_MAX_M or in_features < NF4_BLOCK or in_features % NF4_BLOCK or n_sm < 1:
        raise ValueError(f"bad decode shape: {m} rows, in {in_features}, out {out_features}, {n_sm} SMs")
    n_slabs = -(-out_features // _DEC_SLAB)
    n_kb = in_features // NF4_BLOCK
    stage_bytes = (NF4_BLOCK if kind == "int8" else NF4_BLOCK // 2) * _DEC_SLAB
    stages = max(2, min(4, -(-_DEC_RING_BYTES // (2 * stage_bytes))))
    split = n_sm // n_slabs
    ctas = n_slabs * split if split and n_slabs * split >= _DEC_ALIGNED_FILL * n_sm else n_sm
    return DecodePlan(n_slabs, n_kb, min(ctas, n_slabs * n_kb), stages, -(-m // 8))


def decode_segments(plan: DecodePlan, cta: int) -> List[Tuple[int, int, int]]:
    """Block ``cta``'s work as the kernel walks it: (slab, first scale block,
    end scale block) for each slab its run of units touches, in order. Block
    b takes units [U * b // G, U * (b + 1) // G) of U = n_slabs * n_kb over
    G = ctas blocks."""
    units = plan.n_slabs * plan.n_kb
    u, end = units * cta // plan.ctas, units * (cta + 1) // plan.ctas
    out = []
    while u < end:
        slab = u // plan.n_kb
        seg_end = min(end, (slab + 1) * plan.n_kb)
        out.append((slab, u - slab * plan.n_kb, seg_end - slab * plan.n_kb))
        u = seg_end
    return out


def decode_contributors(plan: DecodePlan, slab: int) -> Tuple[int, int]:
    """(first, last) block whose run touches ``slab``: the blocks whose
    float32 partials the slab's last arrival adds, in this (K) order, when
    more than one block touches it. The kernel computes the same owner
    arithmetic."""
    units = plan.n_slabs * plan.n_kb

    def owner(v):  # the largest b with units * b // ctas <= v
        return ((v + 1) * plan.ctas + units - 1) // units - 1

    return owner(slab * plan.n_kb), owner((slab + 1) * plan.n_kb - 1)


class PrefillPlan(NamedTuple):
    """The prefill kernel's schedule: tiles of ``128 * mw`` rows (two
    warpgroups of ``mw`` 64-row sub-tiles) by 128 columns; K cut into
    ``k_splits`` ranges of ``kb_per_split`` scale blocks (the last may be
    shorter); grid (m_tiles, n_tiles, k_splits)."""

    mw: int
    m_tiles: int
    n_tiles: int
    k_splits: int
    kb_per_split: int


def prefill_plan(m: int, in_features: int, out_features: int, n_sm: int) -> PrefillPlan:
    """Tile height and K split of the prefill kernel for x [m, in] @ w [in,
    out] on a card of ``n_sm`` SMs. Two 64-row sub-tiles a warpgroup (256-row
    tiles) above 128 rows, so each decoded weight tile feeds more rows,
    unless that leaves fewer tiles than SMs; then, while the tiles cannot
    fill the card, K is split into whole scale blocks (at least
    ``_PF_MIN_KB_PER_SPLIT`` each) until they can."""
    n_tiles = -(-out_features // _PF_BN)
    n_kb = in_features // NF4_BLOCK
    mw = 1
    if m > 2 * _PF_SUB_M and -(-m // (4 * _PF_SUB_M)) * n_tiles >= n_sm:
        mw = 2
    m_tiles = -(-m // (2 * _PF_SUB_M * mw))
    tiles = m_tiles * n_tiles
    want = -(-n_sm // tiles)
    per = min(max(_PF_MIN_KB_PER_SPLIT, -(-n_kb // want)), n_kb)
    return PrefillPlan(mw, m_tiles, n_tiles, -(-n_kb // per), per)


_N_SM = {}


def _sm_count(device: torch.device) -> int:
    if device not in _N_SM:
        _N_SM[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _N_SM[device]


def _check_cuda(x2d: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """Validate a CUDA call and return x as a contiguous, 16-byte aligned
    bf16 [M, in] tensor."""
    if w.kind not in _FORMAT_CODES:
        raise ValueError(f"no dequant-matmul kernel for kind {w.kind!r}")
    dev = x2d.device
    if dev.type != "cuda" or w.data.device != dev or w.scales.device != dev:
        raise ValueError(
            f"x and the weight must lie on one CUDA device, got {dev}, {w.data.device}, {w.scales.device}"
        )
    if x2d.dim() != 2 or x2d.shape[1] != w.in_features:
        raise ValueError(f"x must be [M, {w.in_features}], got {tuple(x2d.shape)}")
    k, n = w.in_features, w.out_features
    if k % NF4_BLOCK or n % 16:
        raise ValueError(f"in_features must be a multiple of {NF4_BLOCK} and out_features of 16, got {k}, {n}")
    if w.kind == "int8":
        data_dtype, rows, scale_dtype, scale_shape = torch.int8, w.data.shape[0], torch.float32, (n,)
    else:
        rows = 2 * w.data.shape[0]
        data_dtype, scale_dtype, scale_shape = torch.uint8, torch.bfloat16, (rows // NF4_BLOCK, n)
    if w.data.dtype != data_dtype or w.data.dim() != 2 or w.data.shape[1] != n or rows < k:
        raise ValueError(
            f"{w.kind} data must be {data_dtype} of [>= {k} rows, {n}], got {w.data.dtype} {tuple(w.data.shape)}"
        )
    if w.scales.dtype != scale_dtype or tuple(w.scales.shape) != scale_shape:
        raise ValueError(
            f"{w.kind} scales must be {scale_dtype} {scale_shape}, got {w.scales.dtype} {tuple(w.scales.shape)}"
        )
    for name, t in (("data", w.data), ("scales", w.scales)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the weight's {name} must be contiguous and 16-byte aligned")
    xb = x2d.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()  # a fresh allocation is aligned
    return xb


def quant_matmul_cost(m: int, k: int, n: int, kind: str):
    """(flops, bytes, transcendentals) of one dequant-matmul launch (K5,
    K6) of x [m, k] by a ``kind`` weight [k, n]: 2 * m * k * n flops; x read
    once (bf16), the weight bytes and scales its k loop reaches read once
    (int8: a byte an element and a float32 scale a column; 4-bit: half a
    byte an element and a bf16 scale a 64-row block of a column), the
    output written once (bf16). The split merge's float32 partials are the
    kernel's own traffic, not the function's."""
    weight = k * n + 4 * n if kind == "int8" else k * n // 2 + 2 * (k // NF4_BLOCK) * n
    return 2 * m * k * n, 2 * m * k + weight + 2 * m * n, 0


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = kernel_library().ptt_quant_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def quant_decode_matmul(x2d: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """x [M <= 32, in] @ dequant(w) -> [M, out] in x's dtype."""
    if x2d.device.type == "cpu" and w.data.device.type == "cpu":
        return dequant_matmul_reference(x2d, w)
    xb = _check_cuda(x2d, w)
    m = xb.shape[0]
    if not 1 <= m <= _NF4_DECODE_MAX_M:
        raise ValueError(f"the decode kernel takes 1 to {_NF4_DECODE_MAX_M} rows, got {m}")
    k, n = w.in_features, w.out_features
    plan = decode_plan(m, k, n, _sm_count(xb.device), w.kind)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xb.device)
    # each block's partials: its first and last slab, two column halves
    partial = torch.empty(plan.ctas, 2, 2, m, _DEC_SLAB // 2, dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        tickets = merge_tickets(xb.device, 2 * plan.n_slabs)
        err = kernel_library().ptt_quant_matmul_decode(
            _FORMAT_CODES[w.kind], xb.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
            partial.data_ptr(), tickets.data_ptr(), m, k, n, plan.ctas, plan.stages,
            torch.cuda.current_stream(xb.device).cuda_stream,
        )
    _raise_on(err, "quant decode matmul")
    count_launch(quant_decode_matmul, "launches", w.kind)
    count_cost(f"quant_decode_matmul[{w.kind}]", quant_matmul_cost, m, k, n, w.kind)
    return out.to(x2d.dtype)


quant_decode_matmul.launches = dict.fromkeys(_FORMAT_CODES, 0)


def quant_prefill_matmul(x2d: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """x [M, in] @ dequant(w) -> [M, out] in x's dtype; taken for M > 32."""
    if x2d.device.type == "cpu" and w.data.device.type == "cpu":
        return dequant_matmul_reference(x2d, w)
    xb = _check_cuda(x2d, w)
    m = xb.shape[0]
    k, n = w.in_features, w.out_features
    out = torch.empty(m, n, dtype=torch.bfloat16, device=xb.device)
    if m == 0:
        return out.to(x2d.dtype)
    plan = prefill_plan(m, k, n, _sm_count(xb.device))
    partial = (
        torch.empty(plan.k_splits, m, n, dtype=torch.float32, device=xb.device) if plan.k_splits > 1 else None
    )
    with torch.cuda.device(xb.device):
        err = kernel_library().ptt_quant_matmul_prefill(
            _FORMAT_CODES[w.kind], xb.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(), out.data_ptr(),
            partial.data_ptr() if partial is not None else None, m, k, n, plan.mw, plan.k_splits,
            plan.kb_per_split, torch.cuda.current_stream(xb.device).cuda_stream,
        )
    _raise_on(err, "quant prefill matmul")
    count_launch(quant_prefill_matmul, "launches", w.kind)
    count_cost(f"quant_prefill_matmul[{w.kind}]", quant_matmul_cost, m, k, n, w.kind)
    return out.to(x2d.dtype)


quant_prefill_matmul.launches = dict.fromkeys(_FORMAT_CODES, 0)


def dequant_matmul(x2d: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """x [M, in] @ dequant(w): the decode kernel for M <= 32 rows, the
    prefill kernel above (on the CPU both are the plain version)."""
    if 0 < x2d.shape[0] <= _NF4_DECODE_MAX_M:
        return quant_decode_matmul(x2d, w)
    return quant_prefill_matmul(x2d, w)


def reset_launch_counts() -> None:
    for fn in (quant_decode_matmul, quant_prefill_matmul):
        fn.launches = dict.fromkeys(_FORMAT_CODES, 0)
