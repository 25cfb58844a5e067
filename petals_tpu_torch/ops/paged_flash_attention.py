"""Wrappers of the hand-written CUDA paged-attention kernels
(``csrc/paged_attention.cu``) and the dispatch ``attend`` sends a
``PagedKV`` to.

Each wrapper takes the same arguments as its plain PyTorch version in
ops/paged_attention.py, a floating-point pool or a quantized ``PagedPool``
for k and v. Tensors on the CPU go to the plain version; tensors on a CUDA
device launch the kernel or raise. There is no fallback from one to the
other. Each wrapper counts its kernel launches, so a run can show that its
main path went through the kernels: ``<wrapper>.launches`` (a plain int)
counts the floating-point arm (K1, K2), ``<wrapper>.kv_quant_launches[kind]``
the quantized arm of each kind (K3). A launch inside a CUDA graph capture
is counted by each replay of the graph instead
(telemetry/observatory.py ``count_launch``).

The kernels replace ``_decode_kernel`` and ``_prefill_kernel`` of
petals_tpu/ops/paged_flash_attention.py, with their quantized arms
(``_quant_k_scores``, ``_quant_pv``); the source says what bounds them and
how their design answers that. A bf16 prefill call runs
``paged_prefill_wgmma_kernel`` (tensor cores), a float32 one the CUDA-core
``paged_prefill_kernel``; both skip holes, as the TPU kernels do.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from petals_tpu_torch.ops.paged_attention import PagedPool, kv_quant_kind_of, paged_attend, paged_prefill_attend
from petals_tpu_torch.telemetry.observatory import count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {"int8": 1, "nf4a": 2}  # 0: a floating-point pool
_CODES_DTYPES = {"int8": torch.int8, "nf4a": torch.uint8}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 16
_MAX_PAGE_SIZE = 128
_LIB: Optional[ctypes.CDLL] = None


def kernel_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernels' library."""
    global _LIB
    if _LIB is None:
        from petals_tpu_torch.kernels.build import load

        lib = load("paged_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ptt_paged_decode_attention.argtypes = [p] * 12 + [i] * 11 + [f, p]
        lib.ptt_paged_decode_attention.restype = i
        lib.ptt_paged_prefill_attention.argtypes = [p] * 10 + [i] * 10 + [f, p]
        lib.ptt_paged_prefill_attention.restype = i
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


SPLIT_ROWS = 64  # a decode split's slots are a multiple of this (csrc SPLIT_ROWS)


def decode_split_plan(n_lanes: int, hkv: int, max_rows: int, n_sm: int) -> int:
    """How many splits the decode kernel cuts each lane's needed slots into,
    so that the grid (n_lanes x hkv x n_splits blocks, two resident on an
    SM) covers the card: as many as keep the grid within 2 * n_sm blocks,
    at most one per SPLIT_ROWS of ``max_rows`` (the most slots a lane can
    need: its table's capacity, or the window if that is shorter), and one
    (output written directly, no merge) where the lanes alone fill it. The
    kernel cuts each lane's own range [max(0, kv_len - window), kv_len),
    which lives on the card, into that many runs of equal length rounded up
    to SPLIT_ROWS. Pure: the same arguments give the same count."""
    if n_lanes < 1 or hkv < 1 or max_rows < 1 or n_sm < 1:
        raise ValueError(f"bad decode shape: {n_lanes} lanes, {hkv} kv heads, {max_rows} rows, {n_sm} SMs")
    return min(-(-max_rows // SPLIT_ROWS), max(1, (2 * n_sm) // (n_lanes * hkv)))


_SM_COUNT = {}
_TICKETS = {}
_RETIRED_TICKETS = []  # outgrown counters: a captured graph may still address them


def _sm_count(device: torch.device) -> int:
    if device.index not in _SM_COUNT:
        _SM_COUNT[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SM_COUNT[device.index]


def merge_tickets(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters of an in-launch split merge (this module's
    decode kernel, the dequant-matmul decode kernel) on ``device``'s current
    stream: n uint32 zeros, allocated (zeroed) once and grown when a launch
    needs more; every launch leaves them at zero, so launches on one stream
    share them. A CUDA graph bakes in the counters' address: a grown buffer
    keeps the old one alive for the graphs that read it, and growing is
    refused during a capture (the warm-up on the capture stream, which runs
    the same shapes first, allocates them)."""
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("merge tickets must be allocated before a CUDA graph capture: warm up on its stream")
        if buf is not None:
            _RETIRED_TICKETS.append(buf)
        buf = _TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
    return buf


def _tensors(*args):
    """The tensors of ``args``, a PagedPool's codes and scales included."""
    for a in args:
        if isinstance(a, PagedPool):
            yield from a
        elif a is not None:
            yield a


def _on_cpu(*args) -> bool:
    """True when every tensor lies on the CPU (the plain version's case);
    False when all lie on one CUDA device; raises on anything else."""
    devices = {t.device for t in _tensors(*args)}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"paged attention needs all tensors on one CUDA device, got {devices}")
    return False


def _check(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_pools(q, k_pool, v_pool):
    """Check the pools against q; returns the kernel's storage code and its
    four pool pointers (k, v, k_scales, v_scales)."""
    if isinstance(k_pool, PagedPool) != isinstance(v_pool, PagedPool):
        raise TypeError("k and v pools must both be quantized or both be floating point")
    if not isinstance(k_pool, PagedPool):
        _check("k_pool", k_pool, q.dtype, 4)
        _check("v_pool", v_pool, q.dtype, 4)
        if k_pool.shape != v_pool.shape:
            raise ValueError(f"k/v pools differ: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
        stored = (k_pool, v_pool)
        kv_code, ptrs = 0, (k_pool.data_ptr(), v_pool.data_ptr(), None, None)
    else:
        kind = k_pool.kind
        if v_pool.kind != kind:
            raise TypeError(f"k pool is {kind}, v pool is {v_pool.kind}")
        for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
            _check(f"{name}.codes", pool.codes, _CODES_DTYPES[kind], 4)
            _check(f"{name}.scales", pool.scales, torch.float32, 3)
            if pool.scales.shape != pool.codes.shape[:3]:
                raise ValueError(
                    f"{name}: scales {tuple(pool.scales.shape)} do not match codes {tuple(pool.codes.shape)}"
                )
        if k_pool.codes.shape != v_pool.codes.shape:
            raise ValueError(f"k/v pools differ: {tuple(k_pool.codes.shape)} vs {tuple(v_pool.codes.shape)}")
        stored = (k_pool.codes, v_pool.codes)
        kv_code = _KV_CODES[kind]
        ptrs = (k_pool.codes.data_ptr(), v_pool.codes.data_ptr(),
                k_pool.scales.data_ptr(), v_pool.scales.data_ptr())
    if any(t.data_ptr() % 16 for t in stored):
        raise ValueError("the k and v pools (codes) must be 16-byte aligned: pages are copied 16 bytes at a time")
    return kv_code, ptrs


def _check_common(q, k_pool, v_pool, alibi_slopes, sliding_window):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernels take float32 or bfloat16, got {q.dtype}")
    _check("q", q, q.dtype, 4)
    kv_code, ptrs = _check_pools(q, k_pool, v_pool)
    n_pages, page_size, hkv, d = k_pool.shape  # a PagedPool answers its logical shape
    hq = q.shape[2]
    if q.shape[3] != d or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim must match the pool and be one of {_HEAD_DIMS}, got {q.shape[3]}/{d}")
    if hq % hkv or hq // hkv > _MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: need a group of at most {_MAX_GROUP}")
    # the page sizes the kernels are built and tested for (decode and bf16
    # prefill stage 64-slot tiles, each row through its page; float32
    # prefill 64-row tiles of a page)
    if page_size % 8 or page_size > _MAX_PAGE_SIZE or (page_size > 64 and page_size % 64):
        raise ValueError(f"page_size must be a multiple of 8 up to 64, or 128; got {page_size}")
    if alibi_slopes is not None:
        _check("alibi_slopes", alibi_slopes, torch.float32, 1)
        if alibi_slopes.shape[0] != hq:
            raise ValueError(f"alibi_slopes must be [{hq}], got {tuple(alibi_slopes.shape)}")
    if sliding_window is not None and int(sliding_window) < 1:
        raise ValueError(f"sliding_window must be >= 1 or None, got {sliding_window}")
    return (n_pages, page_size, hkv, d), kv_code, ptrs


def _count(wrapper, k_pool) -> None:
    kind = kv_quant_kind_of(k_pool)
    if kind == "none":
        count_launch(wrapper, "launches")
    else:
        count_launch(wrapper, "kv_quant_launches", kind)


def reset_launch_counts() -> None:
    """Zero every paged-attention launch counter (K1, K2 and K3's arms)."""
    for wrapper in (paged_flash_attend, paged_flash_prefill_attend):
        wrapper.launches = 0
        wrapper.kv_quant_launches = dict.fromkeys(_KV_CODES, 0)


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = kernel_library().ptt_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def paged_flash_attend(
    q: torch.Tensor,
    k_pool,
    v_pool,
    tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ragged paged DECODE attention: the contract of ``paged_attend``. q
    [n_lanes, 1, hq, d]; pools [n_pages, page_size, hkv, d] (q's dtype) or
    ``PagedPool``s of that logical shape; tables [n_lanes, max_pages] int32
    (-1 = hole); positions [n_lanes] int32."""
    if _on_cpu(q, k_pool, v_pool, tables, positions, alibi_slopes):
        return paged_attend(
            q, k_pool, v_pool, tables, positions,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    (n_pages, page_size, hkv, d), kv_code, ptrs = _check_common(q, k_pool, v_pool, alibi_slopes, sliding_window)
    n_lanes, q_len, hq, _ = q.shape
    if q_len != 1:
        raise ValueError(f"the decode kernel takes one token per lane, got q_len={q_len}")
    _check("tables", tables, torch.int32, 2)
    _check("positions", positions, torch.int32, 1)
    if tables.shape[0] != n_lanes or positions.shape[0] != n_lanes:
        raise ValueError(
            f"tables {tuple(tables.shape)} / positions {tuple(positions.shape)} "
            f"do not match {n_lanes} lanes"
        )
    out = torch.empty_like(q)
    max_pages = tables.shape[1]
    if n_lanes == 0 or max_pages == 0:
        return out.zero_()
    max_rows = max_pages * page_size if sliding_window is None else min(max_pages * page_size, int(sliding_window))
    n_splits = decode_split_plan(n_lanes, hkv, max_rows, _sm_count(q.device))
    scratch = (None, None, None)
    if n_splits > 1:  # float32 partials (m, l) and acc of every split, and the merge's counters
        part_ml = torch.empty((n_lanes, hkv, n_splits, hq // hkv, 2), dtype=torch.float32, device=q.device)
        part_acc = torch.empty((n_lanes, hkv, n_splits, hq // hkv, d), dtype=torch.float32, device=q.device)
        scratch = (part_ml.data_ptr(), part_acc.data_ptr(), merge_tickets(q.device, n_lanes * hkv).data_ptr())
    lib = kernel_library()
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_decode_attention(
            q.data_ptr(), *ptrs, tables.data_ptr(),
            positions.data_ptr(), alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), *scratch, _DTYPE_CODES[q.dtype], kv_code, n_lanes, hq, hkv, d, n_pages, page_size,
            max_pages, n_splits, int(sliding_window or 0),
            d**-0.5 if scale is None else float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "paged decode")
    _count(paged_flash_attend, k_pool)
    return out


def chunk_scalars(chunk_pos, n_valid, device: torch.device):
    """``(chunk_pos, n_valid)`` as the prefill kernel reads them: 0-dim
    int32 tensors on ``device``. Tensors pass as they are (cast to int32
    where needed); host integers are range-checked and uploaded, an H2D copy
    that a CUDA graph capture refuses, so a captured caller passes tensors
    it filled before the replay (server/backend.py)."""
    if isinstance(chunk_pos, torch.Tensor) and isinstance(n_valid, torch.Tensor):
        return tuple(t.to(device=device, dtype=torch.int32) for t in (chunk_pos, n_valid))
    chunk_pos, n_valid = int(chunk_pos), int(n_valid)
    if chunk_pos < 0 or n_valid < 0:
        raise ValueError(f"bad chunk: chunk_pos={chunk_pos}, n_valid={n_valid}")
    pair = torch.tensor([chunk_pos, n_valid], dtype=torch.int32, device=device)
    return pair[0], pair[1]


def paged_flash_prefill_attend(
    q: torch.Tensor,
    k_pool,
    v_pool,
    table_row: torch.Tensor,
    chunk_pos,
    n_valid,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ragged paged CHUNKED-PREFILL attention: the contract of
    ``paged_prefill_attend``. q [1, chunk, hq, d]; table_row [max_pages]
    int32; pools as for ``paged_flash_attend``. The chunk's KV must already
    be in the pages. ``chunk_pos`` and ``n_valid`` are 0-dim int32 tensors on
    q's device, which the kernel reads there (``chunk_scalars``), or host
    integers (checked, then uploaded). The kernel's grid depends on the
    chunk's length alone, so a padded chunk (``n_valid`` < its length) and
    any position replay one captured launch; the caller keeps n_valid within
    the chunk's length (rows past it give finite values no caller reads)."""
    if _on_cpu(q, k_pool, v_pool, table_row, alibi_slopes):
        return paged_prefill_attend(
            q, k_pool, v_pool, table_row, chunk_pos, n_valid,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    (n_pages, page_size, hkv, d), kv_code, ptrs = _check_common(q, k_pool, v_pool, alibi_slopes, sliding_window)
    batch, q_len, hq, _ = q.shape
    if batch != 1:
        raise ValueError(f"the prefill kernel serves one lane's chunk, got batch={batch}")
    _check("table_row", table_row, torch.int32, 1)
    if not isinstance(n_valid, torch.Tensor) and int(n_valid) > q_len:
        raise ValueError(f"bad chunk: n_valid={int(n_valid)} > q_len={q_len}")
    chunk_pos, n_valid = chunk_scalars(chunk_pos, n_valid, q.device)
    out = torch.empty_like(q)
    if q_len == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_prefill_attention(
            q.data_ptr(), *ptrs, table_row.data_ptr(), chunk_pos.data_ptr(), n_valid.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None, out.data_ptr(),
            _DTYPE_CODES[q.dtype], kv_code, q_len, hq, hkv, d, n_pages, page_size, table_row.shape[0],
            int(sliding_window or 0), d**-0.5 if scale is None else float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "paged prefill")
    _count(paged_flash_prefill_attend, k_pool)
    return out


reset_launch_counts()


def paged_attend_dispatch(
    q: torch.Tensor,
    k_kv,
    v_kv,
    *,
    q_offset,
    kv_length,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Route a PagedKV attention call (from ``attend``) to the decode or the
    prefill wrapper, its pools (plain or ``PagedPool``) passed as they are. A
    [n_lanes] position tensor is the decode contract (ragged kv_length =
    position + 1); a scalar position is one lane's chunked-prefill chunk
    with ``kv_length - q_offset`` valid rows."""
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
        return paged_flash_attend(
            q, k_kv.pool, v_kv.pool, k_kv.tables, q_offset,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    # a scalar position: host ints, or 0-dim device tensors (a captured step)
    return paged_flash_prefill_attend(
        q, k_kv.pool, v_kv.pool, k_kv.tables[0], q_offset, kv_length - q_offset,
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
    )
