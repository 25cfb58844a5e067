"""Low-rank activation fingerprints, the integrity plane's sensor (the
port's copy of petals_tpu/ops/fingerprint.py; importing that module would
load jax through petals_tpu/ops/__init__).

A fingerprint is a seeded random projection of a hidden-state row into
``FP_DIM`` float32 components: ``fp = h[hidden] @ P[hidden, FP_DIM]``.
The projection matrix is a deterministic function of ``(seed,
hidden_size)``, so the server's step program that fuses the product, the
client that re-derives the digest from the reply it received, and the
canary prober that compares replicas all build the SAME matrix, and a
petals_tpu server's digests compare with a port server's.

Three tolerance regimes (petals_tpu's, calibrated on the CPU in float32):

- ``TOL_EXACT``: same program, same process.
- ``TOL_TRANSPORT``: a client recomputing the digest from the wire reply.
- ``tolerance_for(quant)``: cross-replica comparison, where replicas of
  one span may run different weight quantizations.

The numpy functions are petals_tpu's unchanged. ``fingerprint_rows_torch``
is the device twin the step programs fuse: ``rows.float() @ proj`` on a
float32 projection held on the device (``device_projection``), computed as
a broadcast product and a float32 sum, so it is a float32 product whatever
``torch.backends.cuda.matmul.allow_tf32`` says (TF32 would move a digest by
about 1e-3 relative, the client's ``TOL_TRANSPORT``).

A fingerprint is payload, never a metric label value.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

FP_DIM = 8  # components per digest: small enough to ride every step_meta

# Projection seed: all parties must agree on it for digests to be
# comparable; it is an obfuscation knob, not a secret (a malicious peer
# that can forge matching digests for wrong activations could also just
# compute honestly).
DEFAULT_FP_SEED = 0x5EED

# Same program, same process: bitwise equal on one host; the epsilon
# absorbs nothing but float printing.
TOL_EXACT = 1e-6
# Client recomputation from the wire reply: numpy vs the device's
# accumulation order over one [hidden] @ [hidden, FP_DIM] row (relative).
TOL_TRANSPORT = 1e-3
# Lossy reply compression (e.g. blockwise int8 on the wire) perturbs
# every component of the received hidden state; the client widens to
# this when the negotiated codec is not NONE.
TOL_LOSSY_WIRE = 8e-2

# Cross-replica tolerance by the replica pair's WIDEST quantization mode
# (relative): two honest replicas of one span agree to within the noise
# of their weight representation. petals_tpu's bands, calibrated on the
# CPU in float32; a bf16 replica on a card is measured against them by
# chip_smoke.py's phase 21.
_QUANT_TOL: Dict[str, float] = {
    "none": 1e-3,
    "int8": 5e-2,
    "nf4": 2e-1,
}

# Quantized paged KV pool (``--kv_quant_type``): the cache itself is lossy,
# so every decode step past the first page carries KV requantization noise
# on TOP of whatever the weights contribute. Additive with the weight band
# (independent error sources).
_KV_QUANT_TOL: Dict[str, float] = {
    "none": 0.0,
    "int8": 8e-2,
    "nf4a": 1.5e-1,
}


def tolerance_for(quant: Optional[str], kv_quant: Optional[str] = None) -> float:
    """Relative cross-replica tolerance for a span's quantization mode.

    ``quant`` is the WEIGHT quantization of the widest replica in the pair;
    ``kv_quant`` is the widest paged-KV-pool storage kind. The bands add:
    weight noise and cache requantization noise are independent."""
    tol = _QUANT_TOL.get((quant or "none").lower(), max(_QUANT_TOL.values()))
    if kv_quant is not None and (kv_quant or "none").lower() != "none":
        tol += _KV_QUANT_TOL.get(
            (kv_quant or "none").lower(), max(_KV_QUANT_TOL.values())
        )
    return tol


# ------------------------------------------------------------- enable switch
#
# Read ONCE per process (env) and stable thereafter unless a test flips it
# programmatically: the flag selects which variant of each step program is
# captured (``with_fp`` in its key). Servers and clients in one swarm may
# disagree: the client only verifies when the reply carries a digest.

_enabled: bool = os.environ.get("PETALS_TPU_FINGERPRINT", "").lower() in (
    "1", "true", "yes", "on"
)
_fp_seed: int = int(os.environ.get("PETALS_TPU_FP_SEED", DEFAULT_FP_SEED))


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic override (tests/benchmarks). Flip it BEFORE the step
    programs are captured: ``with_fp`` is part of every step-program key,
    so a flip afterwards captures each program once more."""
    global _enabled
    _enabled = bool(value)


def fp_seed() -> int:
    return _fp_seed


# --------------------------------------------------------------- projection

_proj_cache: Dict[Tuple[int, int], np.ndarray] = {}
_proj_lock = threading.Lock()


def projection(hidden_size: int, seed: Optional[int] = None) -> np.ndarray:
    """The shared [hidden_size, FP_DIM] float32 projection matrix for
    ``(seed, hidden_size)``, cached."""
    key = (int(seed if seed is not None else _fp_seed), int(hidden_size))
    with _proj_lock:
        mat = _proj_cache.get(key)
        if mat is None:
            rng = np.random.RandomState(key[0] & 0x7FFFFFFF)
            # scaled so component magnitude tracks the MEAN activation, not
            # the hidden-size-scaled sum: relative tolerances stay meaningful
            # across model widths
            mat = rng.standard_normal((key[1], FP_DIM)).astype(np.float32)
            mat /= np.float32(np.sqrt(key[1]))
            _proj_cache[key] = mat
        return mat


def fingerprint_rows(rows, proj) -> "np.ndarray":
    """Digest a batch of hidden rows: ``rows [n, hidden] -> [n, FP_DIM]``
    float32 (numpy: the client's and the prober's twin)."""
    return rows.astype(np.float32) @ proj


_device_proj: Dict[Tuple[int, int, str], torch.Tensor] = {}


def device_projection(hidden_size: int, device, seed: Optional[int] = None) -> torch.Tensor:
    """``projection(hidden_size, seed)`` as a float32 tensor on ``device``,
    uploaded once (a step program reads it by address)."""
    device = torch.device(device)
    key = (int(seed if seed is not None else _fp_seed), int(hidden_size), str(device))
    with _proj_lock:
        proj = _device_proj.get(key)
    if proj is None:
        proj = torch.from_numpy(projection(hidden_size, seed)).to(device)
        with _proj_lock:
            proj = _device_proj.setdefault(key, proj)
    return proj


def fingerprint_rows_torch(rows: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The device twin of ``fingerprint_rows``: ``rows [n, hidden] ->
    [n, FP_DIM]`` float32, a true float32 product (no TF32)."""
    return (rows.float().unsqueeze(-1) * proj).sum(dim=-2)


def fingerprint_output(hidden: np.ndarray, hidden_size: int,
                       seed: Optional[int] = None) -> np.ndarray:
    """Client/prober twin: digest of the LAST token row of a step output
    ``hidden [batch, seq, hidden]`` -> ``[FP_DIM]`` float32 (batch 0 —
    inference sessions are single-stream). The server's fused digest uses
    the same convention, so the two are directly comparable."""
    row = np.asarray(hidden, np.float32)[0, -1, :].reshape(1, hidden_size)
    return fingerprint_rows(row, projection(hidden_size, seed))[0]


def fp_close(a: Sequence[float], b: Sequence[float], rtol: float,
             atol: float = 1e-5) -> bool:
    """Digest comparison: max |a-b| <= atol + rtol * max |b| — relative to
    digest magnitude so one threshold works across models and prompts."""
    av = np.asarray(a, np.float64)
    bv = np.asarray(b, np.float64)
    if av.shape != bv.shape:
        return False
    scale = float(np.max(np.abs(bv))) if bv.size else 0.0
    return float(np.max(np.abs(av - bv))) <= atol + rtol * scale if av.size else True


def digest_hex(fp: Sequence[float]) -> str:
    """Stable short hex of a digest for journal/flight evidence, never a
    metric label (unbounded cardinality)."""
    import hashlib

    quantized = np.round(np.asarray(fp, np.float64), 4).tobytes()
    return hashlib.blake2b(quantized, digest_size=8).hexdigest()


def fp_list(fp) -> list:
    """Digest as a compact JSON/msgpack-safe list (rounded float32s)."""
    return [round(float(x), 6) for x in np.asarray(fp).reshape(-1)]


__all__ = [
    "DEFAULT_FP_SEED",
    "FP_DIM",
    "TOL_EXACT",
    "TOL_LOSSY_WIRE",
    "TOL_TRANSPORT",
    "device_projection",
    "digest_hex",
    "enabled",
    "fingerprint_output",
    "fingerprint_rows",
    "fingerprint_rows_torch",
    "fp_close",
    "fp_list",
    "fp_seed",
    "projection",
    "set_enabled",
    "tolerance_for",
]
