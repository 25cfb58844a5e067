"""A small msgpack codec for the wire frames, byte-compatible with
``msgpack.packb(obj, use_bin_type=True)`` and
``msgpack.unpackb(data, raw=False, strict_map_key=False)`` on the types the
frames carry: None, bool, int (64-bit), float, str, bytes, list/tuple, dict.
Anything else (ext types, timestamps) raises."""

from __future__ import annotations

import struct
from typing import Any, List


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 0x100:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 0x10000:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        n = len(raw)
        if n < 0x100:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 0x10000:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 0x10000:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 0x10000:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if 0 <= x <= 0xFF:
        return b"\xcc" + struct.pack(">B", x)
    if -0x80 <= x < 0:
        return b"\xd0" + struct.pack(">b", x)
    if 0 <= x <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", x)
    if -0x8000 <= x < 0:
        return b"\xd1" + struct.pack(">h", x)
    if 0 <= x <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", x)
    if -0x80000000 <= x < 0:
        return b"\xd2" + struct.pack(">i", x)
    if 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", x)
    if -0x8000000000000000 <= x < 0:
        return b"\xd3" + struct.pack(">q", x)
    raise OverflowError(f"integer {x} does not fit in 64 bits")


# fixed-width numbers by type byte: (struct format, size)
_FIXED = {
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
    0xCA: (">f", 4), 0xCB: (">d", 8),
}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}


def unpackb(data: bytes) -> Any:
    view = memoryview(data)
    obj, end = _unpack(view, 0)
    if end != len(view):
        raise ValueError(f"{len(view) - end} trailing bytes after the msgpack object")
    return obj


def _length(view: memoryview, pos: int, size: int):
    (n,) = struct.unpack_from(_LENGTHS[size], view, pos)
    return n, pos + size


def _take(view: memoryview, pos: int, n: int):
    if pos + n > len(view):
        raise ValueError("truncated msgpack data")
    return view[pos : pos + n], pos + n


def _unpack(view: memoryview, pos: int):
    if pos >= len(view):
        raise ValueError("truncated msgpack data")
    b = view[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b < 0xC0:
        raw, pos = _take(view, pos, b & 0x1F)
        return str(raw, "utf-8"), pos
    if 0x90 <= b < 0xA0:
        return _unpack_array(view, pos, b & 0x0F)
    if 0x80 <= b < 0x90:
        return _unpack_map(view, pos, b & 0x0F)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        _take(view, pos, size)
        return struct.unpack_from(fmt, view, pos)[0], pos + size
    if b in (0xC4, 0xC5, 0xC6):
        n, pos = _length(view, pos, {0xC4: 1, 0xC5: 2, 0xC6: 4}[b])
        raw, pos = _take(view, pos, n)
        return bytes(raw), pos
    if b in (0xD9, 0xDA, 0xDB):
        n, pos = _length(view, pos, {0xD9: 1, 0xDA: 2, 0xDB: 4}[b])
        raw, pos = _take(view, pos, n)
        return str(raw, "utf-8"), pos
    if b in (0xDC, 0xDD):
        n, pos = _length(view, pos, 2 if b == 0xDC else 4)
        return _unpack_array(view, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _length(view, pos, 2 if b == 0xDE else 4)
        return _unpack_map(view, pos, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_array(view: memoryview, pos: int, n: int):
    items = []
    for _ in range(n):
        item, pos = _unpack(view, pos)
        items.append(item)
    return items, pos


def _unpack_map(view: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        key, pos = _unpack(view, pos)
        value, pos = _unpack(view, pos)
        if isinstance(key, (list, dict)):
            raise ValueError("unhashable msgpack map key")
        out[key] = value
    return out, pos
