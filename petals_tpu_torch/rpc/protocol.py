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

A step item may ask a whole-model server to generate: ``gen_tokens`` (a
count, which the server clamps) and ``gen_sampling``, a dict of
``do_sample``, ``temperature``, ``top_k``, ``top_p``,
``repetition_penalty``, ``seed`` (in [0, 2**31)), ``offset`` (the draw
index of the chunk's first token) and ``context`` (the token ids so far,
which the repetition penalty sees), as petals_tpu's servers take it
(``validate_gen_sampling``).
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Optional

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


def validate_gen_sampling(payload: Any) -> Optional[dict]:
    """A step item's ``gen_sampling`` dict normalised, with every field
    present, or None for None (petals_tpu/rpc/protocol.py:69-110, the same
    dict and the same errors). Raises ValueError on anything malformed, so
    the handler refuses it before the device is touched."""
    if payload is None:
        return None
    if not isinstance(payload, dict):
        raise ValueError(f"gen_sampling must be a dict, got {type(payload).__name__}")
    out = {
        "do_sample": bool(payload.get("do_sample", False)),
        "temperature": float(payload.get("temperature", 1.0)),
        "top_k": int(payload.get("top_k", 0) or 0),
        "top_p": float(payload.get("top_p", 1.0) if payload.get("top_p") is not None else 1.0),
        "repetition_penalty": float(payload.get("repetition_penalty", 1.0) or 1.0),
        "seed": int(payload.get("seed", 0)),
        "offset": int(payload.get("offset", 0)),
    }
    if not out["temperature"] > 0:
        raise ValueError(f"gen_sampling.temperature must be > 0, got {out['temperature']}")
    if out["top_k"] < 0:
        raise ValueError(f"gen_sampling.top_k must be >= 0, got {out['top_k']}")
    if not 0 < out["top_p"] <= 1:
        raise ValueError(f"gen_sampling.top_p must be in (0, 1], got {out['top_p']}")
    if not out["repetition_penalty"] > 0:
        raise ValueError(f"gen_sampling.repetition_penalty must be > 0, got {out['repetition_penalty']}")
    if not 0 <= out["seed"] < 1 << 31:
        raise ValueError(f"gen_sampling.seed must be in [0, 2^31), got {out['seed']}")
    if out["offset"] < 0:
        raise ValueError(f"gen_sampling.offset must be >= 0, got {out['offset']}")
    context = payload.get("context")
    if context is not None:
        if not isinstance(context, (list, tuple)):
            raise ValueError("gen_sampling.context must be a list of token ids")
        out["context"] = [int(t) for t in context]
    return out
