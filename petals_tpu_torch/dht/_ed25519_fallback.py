"""Pure-Python Ed25519 (RFC 8032), standing in for the `cryptography`
package where it is not installed: dht/identity.py imports it then, so peer
ids, the hello challenge and signed announcements keep their real signature
semantics. The same seeds give the same keys and signatures as the C
implementation, so a port node and a petals_tpu node verify each other's.

Python big integers cost a few ms a sign or verify; a node signs a handful
of hellos and announcements a session.
"""

from __future__ import annotations

import hashlib
import os

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)

# base point B (extended homogeneous coordinates x, y, z, t)
_BY = 4 * pow(5, _P - 2, _P) % _P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_B = (_BX, _BY, 1, _BX * _BY % _P)
_IDENT = (0, 1, 1, 0)


class InvalidSignature(Exception):
    pass


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return e * f % _P, g * h % _P, f * g % _P, e * h % _P


def _mul(s, p):
    q = _IDENT
    while s:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _compress(p):
    x, y, z, _ = p
    zi = pow(z, _P - 2, _P)
    x, y = x * zi % _P, y * zi % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(s: bytes):
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= _P:
        return None
    # recover x from the curve equation: x^2 = (y^2 - 1) / (d y^2 + 1)
    y2 = y * y % _P
    u, v = (y2 - 1) % _P, (_D * y2 + 1) % _P
    x = u * pow(v, _P - 2, _P) % _P
    x = pow(x, (_P + 3) // 8, _P)
    if x * x % _P != u * pow(v, _P - 2, _P) % _P:
        x = x * _SQRT_M1 % _P
    if x * x % _P != u * pow(v, _P - 2, _P) % _P:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = _P - x
    return (x, y, 1, x * y % _P)


def _points_equal(p, q):
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % _P == 0 and (y1 * z2 - y2 * z1) % _P == 0


def _scalars(seed: bytes):
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


class Ed25519PublicKey:
    __slots__ = ("_raw",)

    def __init__(self, raw: bytes):
        self._raw = bytes(raw)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "Ed25519PublicKey":
        if len(data) != 32 or _decompress(data) is None:
            raise ValueError("invalid Ed25519 public key")
        return cls(data)

    def public_bytes_raw(self) -> bytes:
        return self._raw

    def verify(self, signature: bytes, data: bytes) -> None:
        if len(signature) != 64:
            raise InvalidSignature
        a = _decompress(self._raw)
        r = _decompress(signature[:32])
        s = int.from_bytes(signature[32:], "little")
        if a is None or r is None or s >= _L:
            raise InvalidSignature
        k = int.from_bytes(
            hashlib.sha512(signature[:32] + self._raw + data).digest(), "little"
        ) % _L
        if not _points_equal(_mul(s, _B), _add(r, _mul(k, a))):
            raise InvalidSignature


class Ed25519PrivateKey:
    __slots__ = ("_seed", "_a", "_prefix", "_public")

    def __init__(self, seed: bytes):
        self._seed = bytes(seed)
        self._a, self._prefix = _scalars(self._seed)
        self._public = _compress(_mul(self._a, _B))

    @classmethod
    def generate(cls) -> "Ed25519PrivateKey":
        return cls(os.urandom(32))

    @classmethod
    def from_private_bytes(cls, data: bytes) -> "Ed25519PrivateKey":
        if len(data) != 32:
            raise ValueError("Ed25519 private keys are 32 bytes")
        return cls(data)

    def public_key(self) -> Ed25519PublicKey:
        return Ed25519PublicKey(self._public)

    def sign(self, data: bytes) -> bytes:
        r = int.from_bytes(hashlib.sha512(self._prefix + data).digest(), "little") % _L
        enc_r = _compress(_mul(r, _B))
        k = int.from_bytes(
            hashlib.sha512(enc_r + self._public + data).digest(), "little"
        ) % _L
        s = (r + k * self._a) % _L
        return enc_r + int.to_bytes(s, 32, "little")
