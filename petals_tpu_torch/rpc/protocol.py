"""Wire protocol: length-prefixed msgpack frames over asyncio TCP streams,
the same frames as petals_tpu/rpc/protocol.py. One TCP connection multiplexes
many calls, each with a connection-local id:

  {"t": "hello", "peer_id": hex | None,
   "pub"?: hex, "nonce"?: hex}                       — sent once by each side
  {"t": "auth", "sig": hex}                           — identity proof: the
        sender's signature over the peer's key and nonce (dht/identity.py
        hello_challenge_message), sent once it has the peer's hello
  {"t": "req",  "id", "method", "payload"}            — unary request
  {"t": "resp", "id", "ok", "payload"|"error"}        — unary response / stream abort
  {"t": "sopen", "id", "method"}                      — open bidirectional stream
  {"t": "sitem", "id", "payload"}                     — stream item (either way)
  {"t": "send",  "id"}                                — half-close (either way)
  {"t": "cancel", "id"}                               — cancel in-flight call

Frames: 4-byte big-endian length + msgpack body; tensors ride as msgpack bin
(rpc/serialization.py).
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

from petals_tpu_torch.rpc.msgpack_codec import packb, unpackb

MAX_FRAME_BYTES = 1 << 30  # 1 GiB hard cap


async def read_frame(reader: asyncio.StreamReader) -> Any:
    header = await reader.readexactly(4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"Frame of {length} bytes exceeds the {MAX_FRAME_BYTES} byte cap")
    return unpackb(await reader.readexactly(length))


def encode_frame(message: Any) -> bytes:
    body = packb(message)
    if len(body) > MAX_FRAME_BYTES:
        raise ValueError(f"Frame of {len(body)} bytes exceeds the {MAX_FRAME_BYTES} byte cap")
    return struct.pack(">I", len(body)) + body


async def write_frame(writer: asyncio.StreamWriter, message: Any, lock: asyncio.Lock) -> None:
    frame = encode_frame(message)
    async with lock:  # one frame at a time per connection
        writer.write(frame)
        await writer.drain()
