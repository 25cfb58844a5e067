"""The server-side generation draw contract, in numpy: draw ``i`` of a
stream seeded ``s`` is ``jax.random.uniform(jax.random.fold_in(
jax.random.PRNGKey(s), i))`` (petals_tpu/ops/sampling.py:17-22, :96-99), so
a port server, a port client and a petals_tpu server or client draw the
same uniform for the same (seed, draw) and pick the same token by
inverse-CDF.

Four steps, bit for bit what jax computes with its default
``jax_threefry_partitionable`` (True):

1. Threefry-2x32: 20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16, 24),
   a key schedule with ``k0 ^ k1 ^ 0x1BD11BDA``.
2. ``PRNGKey(s)`` is ``(0, s)`` (seeds are below 2**31: the high word is 0),
   and ``fold_in`` is ``threefry(key=(0, s), x=(0, i))``.
3. One 32-bit draw of the folded key is ``y0 ^ y1`` of
   ``threefry(key=folded, x=(0, 0))``.
4. The float: ``bitcast_f32((bits >> 9) | 0x3F800000) - 1.0``, in [0, 1).

Everything is vectorised over equal-shaped arrays of seeds and draws. The
server computes each lane's uniform on the host for the step it builds (its
seeds and draw indices are host integers) and hands the step a float32
``u`` per lane."""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of counters (x0, x1) under keys (k0, k1), all uint32
    arrays of one shape (or scalars). Returns (y0, y1)."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform_for_draw(seed, draw):
    """float32 uniforms in [0, 1): draw ``draw`` of the stream seeded
    ``seed`` (each an integer or an integer array; seeds in [0, 2**31),
    draws in [0, 2**32)). A 0-d array for scalar arguments."""
    seed = np.asarray(seed, np.int64)
    draw = np.asarray(draw, np.int64)
    if (seed < 0).any() or (seed >= 1 << 31).any():
        raise ValueError("seeds must lie in [0, 2**31)")
    seed, draw = np.broadcast_arrays(seed.astype(np.uint32), draw.astype(np.uint32))
    zero = np.zeros_like(seed)
    k0, k1 = threefry2x32(zero, seed, zero, draw)
    y0, y1 = threefry2x32(k0, k1, zero, zero)
    bits = ((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
