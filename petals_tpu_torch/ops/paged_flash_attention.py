"""Wrappers of the hand-written CUDA paged-attention kernels
(``csrc/paged_attention.cu``) and the dispatch ``attend`` sends a
``PagedKV`` to.

Each wrapper takes the same arguments as its plain PyTorch version in
ops/paged_attention.py. Tensors on the CPU go to the plain version; tensors on
a CUDA device launch the kernel or raise. There is no fallback from one to the
other. Each wrapper counts its kernel launches in ``<wrapper>.launches`` (a
plain int), so a run can show that its main path went through the kernels.

The kernels replace ``_decode_kernel`` and ``_prefill_kernel`` of
petals_tpu/ops/paged_flash_attention.py; the source says what bounds them and
how their design answers that.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from petals_tpu_torch.ops.paged_attention import paged_attend, paged_prefill_attend

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
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
        lib.ptt_paged_decode_attention.argtypes = [p] * 7 + [i] * 9 + [f, p]
        lib.ptt_paged_decode_attention.restype = i
        lib.ptt_paged_prefill_attention.argtypes = [p] * 6 + [i] * 11 + [f, p]
        lib.ptt_paged_prefill_attention.restype = i
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version's case);
    False when all lie on one CUDA device; raises on anything else."""
    devices = {t.device for t in tensors if t is not None}
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


def _check_common(q, k_pool, v_pool, alibi_slopes, sliding_window):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernels take float32 or bfloat16, got {q.dtype}")
    _check("q", q, q.dtype, 4)
    _check("k_pool", k_pool, q.dtype, 4)
    _check("v_pool", v_pool, q.dtype, 4)
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k/v pools differ: {tuple(k_pool.shape)} vs {tuple(v_pool.shape)}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("k_pool and v_pool must be 16-byte aligned: pages are copied 16 bytes at a time")
    n_pages, page_size, hkv, d = k_pool.shape
    hq = q.shape[2]
    if q.shape[3] != d or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim must match the pool and be one of {_HEAD_DIMS}, got {q.shape[3]}/{d}")
    if hq % hkv or hq // hkv > _MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: need a group of at most {_MAX_GROUP}")
    # decode stages a whole K and V page in shared memory: at most 128 KB
    if page_size % 8 or page_size > _MAX_PAGE_SIZE or (page_size > 64 and page_size % 64):
        raise ValueError(f"page_size must be a multiple of 8 up to 64, or 128; got {page_size}")
    if alibi_slopes is not None:
        _check("alibi_slopes", alibi_slopes, torch.float32, 1)
        if alibi_slopes.shape[0] != hq:
            raise ValueError(f"alibi_slopes must be [{hq}], got {tuple(alibi_slopes.shape)}")
    if sliding_window is not None and int(sliding_window) < 1:
        raise ValueError(f"sliding_window must be >= 1 or None, got {sliding_window}")
    return n_pages, page_size, hkv, d


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = kernel_library().ptt_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} ({msg})")


def paged_flash_attend(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    positions: torch.Tensor,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ragged paged DECODE attention: the contract of ``paged_attend``. q
    [n_lanes, 1, hq, d]; pools [n_pages, page_size, hkv, d]; tables [n_lanes,
    max_pages] int32 (-1 = hole); positions [n_lanes] int32."""
    if _on_cpu(q, k_pool, v_pool, tables, positions, alibi_slopes):
        return paged_attend(
            q, k_pool, v_pool, tables, positions,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    n_pages, page_size, hkv, d = _check_common(q, k_pool, v_pool, alibi_slopes, sliding_window)
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
    if n_lanes == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
            positions.data_ptr(), alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            out.data_ptr(), _DTYPE_CODES[q.dtype], n_lanes, hq, hkv, d, n_pages, page_size,
            tables.shape[1], int(sliding_window or 0),
            d**-0.5 if scale is None else float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "paged decode")
    paged_flash_attend.launches += 1
    return out


paged_flash_attend.launches = 0


def paged_flash_prefill_attend(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table_row: torch.Tensor,
    chunk_pos: int,
    n_valid: int,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ragged paged CHUNKED-PREFILL attention: the contract of
    ``paged_prefill_attend``. q [1, chunk, hq, d]; table_row [max_pages]
    int32; ``chunk_pos`` and ``n_valid`` are host integers. The chunk's KV
    must already be in the pages."""
    if _on_cpu(q, k_pool, v_pool, table_row, alibi_slopes):
        return paged_prefill_attend(
            q, k_pool, v_pool, table_row, chunk_pos, n_valid,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    n_pages, page_size, hkv, d = _check_common(q, k_pool, v_pool, alibi_slopes, sliding_window)
    batch, q_len, hq, _ = q.shape
    if batch != 1:
        raise ValueError(f"the prefill kernel serves one lane's chunk, got batch={batch}")
    _check("table_row", table_row, torch.int32, 1)
    chunk_pos, n_valid = int(chunk_pos), int(n_valid)
    if chunk_pos < 0 or not 0 <= n_valid <= q_len:
        raise ValueError(f"bad chunk: chunk_pos={chunk_pos}, n_valid={n_valid}, q_len={q_len}")
    out = torch.empty_like(q)
    if q_len == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(q.device):
        err = lib.ptt_paged_prefill_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table_row.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None, out.data_ptr(),
            _DTYPE_CODES[q.dtype], q_len, hq, hkv, d, n_pages, page_size, table_row.shape[0],
            chunk_pos, chunk_pos + n_valid, int(sliding_window or 0),
            d**-0.5 if scale is None else float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "paged prefill")
    paged_flash_prefill_attend.launches += 1
    return out


paged_flash_prefill_attend.launches = 0


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
    prefill wrapper. A [n_lanes] position tensor is the decode contract
    (ragged kv_length = position + 1); a scalar position is one lane's
    chunked-prefill chunk with ``kv_length - q_offset`` valid rows."""
    if isinstance(q_offset, torch.Tensor) and q_offset.dim() == 1:
        return paged_flash_attend(
            q, k_kv.pool, v_kv.pool, k_kv.tables, q_offset,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
        )
    chunk_pos = int(q_offset)
    return paged_flash_prefill_attend(
        q, k_kv.pool, v_kv.pool, k_kv.tables[0], chunk_pos, int(kv_length) - chunk_pos,
        alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale,
    )
