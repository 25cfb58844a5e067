"""Causal flash attention over a dense, preallocated KV buffer: the wrapper
of the hand-written CUDA kernel (``csrc/flash_attention.cu``), its plain
PyTorch version, and the shape rule ``attend`` dispatches by.

Contract (petals_tpu/ops/flash_attention.py ``flash_attend``): q [batch,
q_len, hq, d]; k, v [batch, kv_buf_len, hkv, d] of which the first
``kv_length`` positions are valid; query row i sits at absolute position
``q_offset + i`` and sees kv position j when ``j <= q_offset + i``,
``j < kv_length`` and, with a sliding window, ``j > q_offset + i - window``.
``q_offset`` and ``kv_length`` are scalars shared by the batch. GQA, optional
ALiBi, Gemma-2's logit softcap, float32 softmax; a row that sees nothing
gives exact zeros. head_dim 64, 96, 128 or 256.

``q_offset`` and ``kv_length`` are host integers or 0-dim integer tensors on
the device (a captured step's chunk position and real length): the kernel
reads them from the card, so a CUDA graph that captures it replays a padded
chunk at any position. Host integers are checked and uploaded, an H2D copy
that a capture refuses; tensors are read unchecked, and the kernel clamps
kv_length to the buffer.

Tensors on the CPU go to the plain version; tensors on a CUDA device launch
the kernel or raise. There is no fallback from one to the other.
``flash_attend.launches`` (a plain int) counts the kernel's launches
(telemetry/observatory.py ``count_launch``: a launch inside a capture is
counted by each replay), so a run can show that its main path went through
the kernel. Each launch also reports the work of the function it computes
to a capture that counts its cost (``count_cost``, ``flash_cost``).

The kernel replaces ``_kernel`` of petals_tpu/ops/flash_attention.py; the
source says what bounds it and how its design answers that. It reads q, k and
v through their strides (a session's per-block cache is a view of the stacked
buffer) and masks ragged lengths itself, so the TPU kernel's shape rule
``kv_buf_len % 128 == 0`` has no counterpart here: any buffer length is
served.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from petals_tpu_torch.ops.attention import DEFAULT_MASK_VALUE, causal_work
from petals_tpu_torch.telemetry.observatory import count_cost, count_launch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 96, 128, 256)  # the wgmma tiles pad 96 to 128 columns in shared memory
MIN_FLASH_Q_LEN = 8  # below this a step is a decode shape: plain attention
# the widest GQA group the bf16 (wgmma) kernel is tested at on the card:
# Falcon-7B's 71 query heads over one kv head. A block packs 64 rows of query
# positions x the heads of a group tile (ops/attention.py group_tiles: a
# group of more than 16 is cut into tiles, one grid index each)
_MAX_GROUP = 71
_LIB: Optional[ctypes.CDLL] = None


def kernel_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel's library."""
    global _LIB
    if _LIB is None:
        from petals_tpu_torch.kernels.build import load

        lib = load("flash_attention")
        p, i, s, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.ptt_flash_attention.argtypes = [p] * 5 + [i] * 6 + [s] * 9 + [p] * 2 + [i] * 2 + [f, f, p]
        lib.ptt_flash_attention.restype = i
        lib.ptt_flash_error_string.argtypes = [i]
        lib.ptt_flash_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def reset_launch_counts() -> None:
    """Zero the kernel's launch counter (K4)."""
    flash_attend.launches = 0


def flash_cost(batch: int, q_len: int, hq: int, hkv: int, d: int, kv_buf_len: int, itemsize: int,
               sliding_window: Optional[int] = None, softcap: Optional[float] = None, alibi: bool = False):
    """(flops, bytes, transcendentals) of one launch (K4), from its shapes
    alone, at capacity (telemetry/op_cost.py): each batch row's queries at
    the last ``q_len`` positions of its buffer, every buffer row valid,
    causal and windowed. Per visible (query, kv) pair a score and a P.V
    product, 2 * d flops each, and one exp (a tanh more under a softcap);
    bytes: q read and the output written, the K/V rows some row sees, the
    two int32 position scalars and the ALiBi slopes."""
    kv_len = max(kv_buf_len, q_len)
    seen, pairs = causal_work(kv_len - q_len, q_len, kv_len, sliding_window)
    nbytes = batch * (2 * q_len * hq * d + 2 * seen * hkv * d) * itemsize + 8 + (4 * hq if alibi else 0)
    return 4 * batch * hq * d * pairs, nbytes, batch * hq * pairs * (2 if softcap else 1)


def flash_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sliding_window: Optional[int] = None) -> bool:
    """Whether ``attend(use_flash=True)`` sends these shapes to the kernel:
    anything above a decode shape. Unlike the TPU kernel's rule, the buffer
    length is free (the kernel masks the ragged edge itself), and a logit
    softcap rides along (the kernel applies it)."""
    if sliding_window is not None and sliding_window <= 0:
        return False
    return q.shape[1] >= MIN_FLASH_Q_LEN


def flash_attend_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset=0,
    kv_length=None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the kernel, with its arithmetic: float32 scores (a
    ``softcap`` caps them after the scale, before ALiBi) and softmax, the unnormalised probabilities rounded to the storage type for
    the PV product, a float32 sum divided by ``max(l, 1e-30)`` (l summed
    unrounded) and rounded once to ``q.dtype``. In float32 it is
    ``attend_reference`` up to the order of the division. ``q_offset`` and
    ``kv_length`` are host integers or 0-dim integer tensors (read where they
    lie, kv_length clamped to the buffer as the kernel clamps it); both give
    the same bytes."""
    batch, q_len, hq, d = q.shape
    kv_buf_len, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    group = hq // hkv
    scale = d**-0.5 if scale is None else float(scale)
    device = q.device
    q_offset = _scalar(q_offset, device)
    kv_length = _scalar(kv_buf_len if kv_length is None else kv_length, device).clamp(0, kv_buf_len)

    qg = q.float().reshape(batch, q_len, hkv, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    logits = logits.reshape(batch, hq, q_len, kv_buf_len)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    kv_pos = torch.arange(kv_buf_len, dtype=torch.int32, device=device)
    if alibi_slopes is not None:
        logits = logits + alibi_slopes.float()[None, :, None, None] * kv_pos.float()
    q_pos = q_offset + torch.arange(q_len, dtype=torch.int32, device=device)
    mask = (kv_pos[None, :] < kv_length) & (kv_pos[None, :] <= q_pos[:, None])
    if sliding_window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - int(sliding_window))
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1).clamp_min(1e-30)  # [b, hq, q]
    pg = p.to(v.dtype).float().reshape(batch, hkv, group, q_len, kv_buf_len)
    acc = torch.einsum("bkgqs,bskd->bqkgd", pg, v.float()).reshape(batch, q_len, hq, d)
    return (acc / l.permute(0, 2, 1)[..., None]).to(q.dtype)


def _scalar(x, device: torch.device) -> torch.Tensor:
    """A host integer or a 0-dim integer tensor as a 0-dim int32 tensor on
    ``device`` (no copy for an int32 tensor already there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.tensor(int(x), dtype=torch.int32, device=device)


def _device_scalars(q_offset, kv_length, kv_buf_len: int, device: torch.device):
    """(q_offset, kv_length) as 0-dim int32 tensors on ``device``, as the
    kernel reads them. Tensors pass as they are (cast where needed); host
    integers are range-checked and uploaded together."""
    if isinstance(q_offset, torch.Tensor) or isinstance(kv_length, torch.Tensor):
        if kv_length is None:
            kv_length = kv_buf_len
        return _scalar(q_offset, device), _scalar(kv_length, device)
    q_offset = int(q_offset)
    kv_length = kv_buf_len if kv_length is None else int(kv_length)
    if q_offset < 0 or not 0 <= kv_length <= kv_buf_len:
        raise ValueError(f"bad positions: q_offset={q_offset}, kv_length={kv_length}, buffer {kv_buf_len}")
    pair = torch.tensor([q_offset, kv_length], dtype=torch.int32, device=device)
    return pair[0], pair[1]


def _check_strided(name: str, t: torch.Tensor, dtype, head_dim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} like q, got {t.dtype}")
    if t.dim() != 4 or t.shape[3] != head_dim:
        raise ValueError(f"{name} must be [batch, length, heads, {head_dim}], got {tuple(t.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous, got strides {t.stride()}")
    # rows are copied 16 bytes at a time
    if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
        raise ValueError(f"{name} must be 16-byte aligned in every row (strides {t.stride()})")


def flash_attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset=0,
    kv_length=None,
    alibi_slopes: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Dense-buffer causal flash attention (module docstring). q, k and v may
    be strided views whose head dim is contiguous; the output is a new
    contiguous tensor of q's shape and dtype."""
    tensors = [t for t in (q, k, v, alibi_slopes) if t is not None]
    devices = {t.device for t in tensors}
    if all(dev.type == "cpu" for dev in devices):
        return flash_attend_reference(
            q, k, v, q_offset=q_offset, kv_length=kv_length,
            alibi_slopes=alibi_slopes, sliding_window=sliding_window, scale=scale, softcap=softcap,
        )
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"flash attention needs all tensors on one CUDA device, got {devices}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [batch, q_len, heads, head_dim], got {tuple(q.shape)}")
    batch, q_len, hq, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS}, got {d}")
    _check_strided("q", q, q.dtype, d)
    _check_strided("k", k, q.dtype, d)
    _check_strided("v", v, q.dtype, d)
    if k.shape != v.shape or k.shape[0] != batch:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    kv_buf_len, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if q.dtype == torch.bfloat16 and hq // hkv > _MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} kv heads: the bf16 kernel is tested at a group of "
                         f"at most {_MAX_GROUP}")
    if alibi_slopes is not None:
        if alibi_slopes.dtype != torch.float32 or tuple(alibi_slopes.shape) != (hq,) or not alibi_slopes.is_contiguous():
            raise ValueError(f"alibi_slopes must be contiguous float32 [{hq}], got {alibi_slopes.dtype} {tuple(alibi_slopes.shape)}")
    if sliding_window is not None and int(sliding_window) < 1:
        raise ValueError(f"sliding_window must be >= 1 or None, got {sliding_window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    q_off_t, kv_len_t = _device_scalars(q_offset, kv_length, kv_buf_len, q.device)
    out = torch.empty((batch, q_len, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = kernel_library()
    with torch.cuda.device(q.device):
        err = lib.ptt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None, out.data_ptr(),
            _DTYPE_CODES[q.dtype], batch, q_len, hq, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            q_off_t.data_ptr(), kv_len_t.data_ptr(), kv_buf_len, int(sliding_window or 0),
            d**-0.5 if scale is None else float(scale), float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        msg = lib.ptt_flash_error_string(err).decode()
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err} ({msg})")
    count_launch(flash_attend, "launches")
    count_cost("flash_attention", flash_cost, batch, q_len, hq, hkv, d, kv_buf_len, q.element_size(),
               sliding_window, softcap, alibi_slopes is not None)
    return out


reset_launch_counts()
