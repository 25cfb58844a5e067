"""Weight-only quantization: the formats of petals_tpu/ops/quant.py, their
encoders, ``dequantize``, and ``quant_matmul`` with its plain version.

Formats (weights stored [in, out], as the blocks keep them):

- int8: symmetric per-output-column absmax; data int8 [in_stored, out],
  scales f32 [out].
- nf4 / nf4a / int4: blocks of ``NF4_BLOCK`` = 64 rows along the input axis
  per output column, two codes per byte (the low nibble holds row 2r, the
  high nibble row 2r + 1); data uint8 [in_stored / 2, out], scales bf16
  [in_stored / 64, out]. nf4 decodes through the QLoRA codebook, nf4a
  through the cubic ``A*d + B*d**3`` with ``d = c - 7.5``, int4 as
  ``c - 8``.
- ``+o`` kinds: a 4-bit weight whose in/64 largest input channels are
  zeroed in the packed stream and carried as dense bf16 residual rows.

Rows are zero-padded to a multiple of ``_TK``: that padding is part of the
stored layout, so the bytes equal the JAX package's. Every encoder is
byte-identical to its JAX counterpart on the same weights.

``quant_matmul`` sends a quantized weight on a CUDA tensor to the
hand-written dequant-matmul kernels (ops/quant_matmul.py) and on a CPU
tensor to ``dequant_matmul_reference``, the plain version: x rounded to
bf16 against ``dequantize(w, bf16)``, summed in float32 and rounded once
to bf16, then cast to x's dtype, as the JAX package's XLA path computes it.

Not ported, on purpose:

- ``StackedQuantLinear`` and the backend's ``_split_quant`` /
  ``_reattach_quant``: they exist so ``lax.scan`` can keep the stacked
  bytes as consts; the port loops over per-block dicts and indexes a
  stacked leaf per block.
- ``_FORCE_XLA_PATH`` / ``force_xla_quant_matmul``: tensor parallelism
  has not been ported.
- ``maybe_autotune_nf4_decode`` / ``set_nf4_decode_path``: on the card the
  port always takes its kernel.
- the ``custom_vjp`` backward (dequant-transpose): it belongs to the
  training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NF4_BLOCK = 64
_TK = 1024  # input-axis pad unit of the stored layout (the Pallas k-tile)

# QLoRA NormalFloat4 codebook (ascending)
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

# NF4A: the cubic code map v(c) = A*d + B*d^3, d = c - 7.5, least-squares
# fitted to the NF4 levels; decodes by arithmetic alone
NF4A_A = 0.071834915950145642
NF4A_B = 0.0010216002528025852
_NF4A_D = np.arange(16, dtype=np.float64) - 7.5
NF4A_CODE = (NF4A_A * _NF4A_D + NF4A_B * _NF4A_D**3).astype(np.float32)

PACKED_KINDS = ("nf4", "nf4a", "int4")
OUTLIER_DIVISOR = 64  # outlier channels kept dense: in_features // 64

# XLA rewrites a division by a constant into a multiplication by its float32
# reciprocal, so the JAX package's encoders scale by these
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))
_RECIP_7 = float(np.float32(1.0) / np.float32(7.0))

# Encode in column chunks past this size: the encode makes an f32 copy of
# the weight, and chunking bounds that transient (at most ~1 GiB) on the
# card. The encode is column-separable, so chunking changes no output bit.
_ENCODE_CHUNK_ELEMS = 1 << 28


@dataclasses.dataclass
class QuantizedLinear:
    """A quantized [in, out] weight. ``kind`` in {"int8", "nf4", "nf4a", "int4"}."""

    kind: str
    data: torch.Tensor  # int8 [in_stored, out] | uint8 [in_stored // 2, out]
    scales: torch.Tensor  # f32 [out] | bf16 [in_stored // 64, out]
    in_features: int
    out_features: int

    @property
    def shape(self):
        # leading stack axes + the logical matmul shape
        return (*self.data.shape[:-2], self.in_features, self.out_features)

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() + self.scales.numel() * self.scales.element_size()

    def to(self, device) -> "QuantizedLinear":
        return QuantizedLinear(self.kind, self.data.to(device), self.scales.to(device),
                               self.in_features, self.out_features)


@dataclasses.dataclass
class OutlierQuantLinear:
    """A packed 4-bit weight whose top in/64 input channels (by max
    magnitude) are zeroed in the packed stream and kept as dense bf16 rows.
    ``w_out`` holds the RESIDUAL against the packed stream's decode of the
    zeroed rows, so packed + side equals the dense weight's dequantization
    for any base kind."""

    inner: QuantizedLinear
    idx: torch.Tensor  # int32 [k] sorted outlier input-channel indices
    w_out: torch.Tensor  # bf16 [k, out] residual rows

    @property
    def kind(self) -> str:
        return f"{self.inner.kind}+o"

    @property
    def shape(self):
        return self.inner.shape

    @property
    def in_features(self) -> int:
        return self.inner.in_features

    @property
    def out_features(self) -> int:
        return self.inner.out_features

    @property
    def nbytes(self) -> int:
        return (
            self.inner.nbytes
            + self.idx.numel() * self.idx.element_size()
            + self.w_out.numel() * self.w_out.element_size()
        )

    def to(self, device) -> "OutlierQuantLinear":
        return OutlierQuantLinear(self.inner.to(device), self.idx.to(device), self.w_out.to(device))


QUANTIZED_TYPES = (QuantizedLinear, OutlierQuantLinear)


def _outlier_idx(w: torch.Tensor, k: int) -> torch.Tensor:
    """The k input rows of largest max-magnitude, sorted. Ties go to the
    lower index, as ``jax.lax.top_k`` breaks them."""
    mags = w.abs().amax(dim=1).float()
    order = torch.sort(mags, descending=True, stable=True).indices
    return torch.sort(order[:k]).values.to(torch.int32)


def _zero_decode_value(kind: str) -> float:
    """The decoded value of an exactly-zero weight under ``kind``'s encode:
    int4 encodes 0 as code 8 (value 0); nf4's level 7 is 0.0; nf4a's
    symmetric levels have no zero, so 0 lands on level 7 (~ -0.036)."""
    if kind == "int4":
        return 0.0
    if kind not in ("nf4", "nf4a"):
        raise ValueError(
            f"outlier channels support the blockwise 4-bit kinds, not {kind!r}"
        )
    code = NF4_CODE if kind == "nf4" else NF4A_CODE
    midpoints = (code[:-1] + code[1:]) / 2.0
    return float(code[int((midpoints < 0.0).sum())])


def _outlier_residual(w: torch.Tensor, idx: torch.Tensor, scales: torch.Tensor, z: float) -> torch.Tensor:
    idx = idx.long()
    rows = w.index_select(0, idx).float()
    srows = scales.index_select(0, torch.div(idx, NF4_BLOCK, rounding_mode="floor")).float()
    return (rows - srows * z).to(torch.bfloat16)  # z is a float32 value


def quantize_with_outliers(w: torch.Tensor, base_kind: str) -> OutlierQuantLinear:
    """4-bit ``base_kind`` with the top in/64 input channels kept dense, as
    residuals against the packed decode of the zeroed rows."""
    n_in, _ = w.shape
    k = max(n_in // OUTLIER_DIVISOR, 1)
    idx = _outlier_idx(w, k)
    main = w.clone()
    main[idx.long()] = 0
    inner = quantize(main, base_kind)
    del main
    residual = _outlier_residual(w, idx, inner.scales, _zero_decode_value(base_kind))
    return OutlierQuantLinear(inner, idx, residual)


# ----------------------------------------------------------------------------------
# Quantize
# ----------------------------------------------------------------------------------


def _encode_int8(w: torch.Tensor):
    wf = w.float()
    absmax = wf.abs().amax(dim=0)  # [out]
    scale = torch.clamp_min(absmax, 1e-8) * _RECIP_127
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-output-column int8 (w: [in, out]); rows zero-padded to
    the k-tile (zero rows are exact), in_features records the logical size."""
    n_in, n_out = w.shape
    pad = (-n_in) % _TK
    if pad:
        w = torch.cat([w, w.new_zeros(pad, n_out)], dim=0)
    q, scale = _encode_int8(w)
    return QuantizedLinear("int8", q, scale.float(), n_in, n_out)


def _pad_rows(w: torch.Tensor):
    """Zero-pad the input axis to a multiple of ``_TK`` (zero rows encode
    exactly in every 4-bit kind)."""
    n_in, n_out = w.shape
    if n_in % NF4_BLOCK:
        raise ValueError(f"in_features {n_in} must be a multiple of {NF4_BLOCK}")
    pad = (-n_in) % _TK
    if pad:
        w = torch.cat([w, w.new_zeros(pad, n_out)], dim=0)
    return w, n_in + pad


def _encode_4bit(w: torch.Tensor, kind: str):
    """(packed codes uint8 [stored // 2, out], scales bf16 [stored // 64, out])."""
    n_stored, n_out = w.shape
    wf = w.float().reshape(n_stored // NF4_BLOCK, NF4_BLOCK, n_out)
    absmax = wf.abs().amax(dim=1)  # [blocks, out]
    if kind in ("nf4", "nf4a"):
        normed = wf / torch.clamp_min(absmax, 1e-8)[:, None, :]  # in [-1, 1]
        del wf
        # nearest level = count of midpoints below the value; the midpoints
        # are float32 values computed as numpy float32, as the JAX encode does
        code = NF4_CODE if kind == "nf4" else NF4A_CODE
        midpoints = (code[:-1] + code[1:]) / 2.0
        codes = torch.zeros(normed.shape, dtype=torch.uint8, device=w.device)
        for m in midpoints.tolist():
            codes += normed > m
        scales = absmax
    else:
        # affine: value = (code - 8) * scale, scale = absmax / 7, codes in [1, 15]
        scales = torch.clamp_min(absmax, 1e-8) * _RECIP_7
        codes = (torch.clamp(torch.round(wf / scales[:, None, :]), -7, 7) + 8).to(torch.uint8)
        del wf
    codes = codes.reshape(n_stored, n_out)
    packed = codes[0::2] | (codes[1::2] << 4)
    return packed, scales.to(torch.bfloat16)


def _encode_4bit_chunked(w: torch.Tensor, kind: str):
    n_stored, n_out = w.shape
    if w.numel() <= _ENCODE_CHUNK_ELEMS:
        return _encode_4bit(w, kind)
    cols = max(_ENCODE_CHUNK_ELEMS // n_stored, 1)
    packed_parts, scale_parts = [], []
    for j in range(0, n_out, cols):
        p, s = _encode_4bit(w[:, j:j + cols], kind)
        packed_parts.append(p)
        scale_parts.append(s)
    return torch.cat(packed_parts, dim=1), torch.cat(scale_parts, dim=1)


def _quantize_4bit(w: torch.Tensor, kind: str) -> QuantizedLinear:
    n_in, n_out = w.shape
    w, _ = _pad_rows(w)
    packed, scales = _encode_4bit_chunked(w, kind)
    return QuantizedLinear(kind, packed, scales, n_in, n_out)


def quantize_nf4(w: torch.Tensor) -> QuantizedLinear:
    """Blockwise-64 NF4 along the input axis (w: [in, out], in % 64 == 0)."""
    return _quantize_4bit(w, "nf4")


def quantize_int4(w: torch.Tensor) -> QuantizedLinear:
    """Blockwise-64 affine int4: value = (code - 8) * scale, scale = absmax / 7."""
    return _quantize_4bit(w, "int4")


def quantize_nf4a(w: torch.Tensor) -> QuantizedLinear:
    """Blockwise-64 NF4A: the cubic levels of ``NF4A_CODE``, absmax scales."""
    return _quantize_4bit(w, "nf4a")


def quantize(w: torch.Tensor, kind: str):
    if kind.endswith("+o"):
        return quantize_with_outliers(w, kind[:-2])
    if kind == "int8":
        return quantize_int8(w)
    if kind in PACKED_KINDS:
        return _quantize_4bit(w, kind)
    raise ValueError(f"Unknown quantization kind {kind!r}")


# ----------------------------------------------------------------------------------
# Dequantize / matmul
# ----------------------------------------------------------------------------------


def code_table(kind: str, device=None) -> torch.Tensor:
    """The 16 float32 levels of a 4-bit kind (int4: code - 8)."""
    table = {"nf4": NF4_CODE, "nf4a": NF4A_CODE}.get(kind)
    if table is None:
        table = np.arange(16, dtype=np.float32) - 8.0
    return torch.from_numpy(table).to(device)


def dequantize(q, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The dense weight [..., in, out]; handles leading stack axes (an
    OutlierQuantLinear only per block)."""
    if isinstance(q, OutlierQuantLinear):
        if q.inner.data.dim() != 2:
            raise ValueError("outlier dequantize is per block (2-D)")
        deq = dequantize(q.inner, torch.float32)
        # ADD the residual: packed + side, as the serving matmul computes it
        deq.index_add_(0, q.idx.long(), q.w_out.float())
        return deq.to(dtype)
    if q.kind == "int8":
        deq = (q.data.float() * q.scales[..., None, :].float()).to(dtype)
        return deq[..., : q.in_features, :]
    data = q.data
    table = code_table(q.kind, data.device)
    lo = table[(data & 0x0F).long()]
    hi = table[(data >> 4).long()]
    vals = torch.stack([lo, hi], dim=-2)  # [..., half, 2, out]
    *lead, half, _two, out = vals.shape
    blocks = vals.reshape(*lead, half * 2 // NF4_BLOCK, NF4_BLOCK, out)
    deq = (blocks * q.scales[..., :, None, :].float()).reshape(*lead, half * 2, out)
    return deq[..., : q.in_features, :].to(dtype)


def dequant_matmul_reference(x2d: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """Plain version of the dequant-matmul kernels: x [M, in] rounded to
    bf16 against ``dequantize(w, bf16)``, summed in float32 and rounded once
    to bf16, then cast to x's dtype."""
    deq = dequantize(w, torch.bfloat16)
    out = x2d.to(torch.bfloat16).float() @ deq.float()
    return out.to(torch.bfloat16).to(x2d.dtype)


def quant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is dense, a QuantizedLinear or an OutlierQuantLinear.
    A quantized weight on a CUDA tensor goes to the dequant-matmul kernels,
    on a CPU tensor to the plain version."""
    if isinstance(w, OutlierQuantLinear):
        # the packed stream plus the dense outlier side term x[..., idx] @
        # w_out, in bf16 with float32 sums (a torch gather and matmul: the
        # JAX package computes it outside its kernels too)
        xs = x.index_select(-1, w.idx.long()).to(torch.bfloat16).float()
        side = (xs @ w.w_out.float()).to(torch.bfloat16).to(x.dtype)
        return quant_matmul(x, w.inner) + side
    if not isinstance(w, QuantizedLinear):
        return x @ w
    from petals_tpu_torch.ops.quant_matmul import dequant_matmul

    lead = x.shape[:-1]
    out = dequant_matmul(x.reshape(-1, w.in_features), w)
    return out.reshape(*lead, w.out_features)


# ----------------------------------------------------------------------------------
# Sizing
# ----------------------------------------------------------------------------------

BITS_PER_PARAM = {
    "none": 16.0, "int8": 8.25, "nf4": 4.25, "nf4a": 4.25, "int4": 4.25,
    # +o: top in/64 input channels kept dense bf16 (16 bits / 64 rows)
    "nf4a+o": 4.5, "int4+o": 4.5,
}


def quantized_bytes(n_params: int, kind: str) -> int:
    return int(n_params * BITS_PER_PARAM[kind] / 8)
