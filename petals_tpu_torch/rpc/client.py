"""Asyncio RPC client with connection multiplexing: the stub side of the
wire protocol (petals_tpu/rpc/client.py without the identity handshake).
One ``RpcClient`` owns one TCP connection; concurrent unary calls and streams
share it, matched by call id. A lost connection fails every call in flight."""

from __future__ import annotations

import asyncio
import itertools
import logging
from typing import Any, AsyncIterator, Optional

from petals_tpu_torch.rpc.protocol import read_frame, write_frame
from petals_tpu_torch.rpc.server import RpcError

logger = logging.getLogger(__name__)

_END = object()


class StreamCall:
    """A bidirectional stream: ``send``/``end`` feed the server, ``recv`` reads."""

    def __init__(self, client: "RpcClient", call_id: int):
        self._client = client
        self._call_id = call_id
        self._inbound: asyncio.Queue = asyncio.Queue()
        self._closed = False

    async def send(self, payload: Any) -> None:
        if self._closed:
            raise RpcError("Stream is closed")
        await self._client._send({"t": "sitem", "id": self._call_id, "payload": payload})

    async def end(self) -> None:
        """Half-close: no more requests will be sent."""
        await self._client._send({"t": "send", "id": self._call_id})

    async def recv(self, timeout: Optional[float] = None) -> Any:
        """Next response item; raises StopAsyncIteration at end of stream."""
        item = await asyncio.wait_for(self._inbound.get(), timeout)
        if item is _END:
            self._closed = True
            raise StopAsyncIteration
        if isinstance(item, Exception):
            self._closed = True
            raise item
        return item

    def __aiter__(self) -> AsyncIterator[Any]:
        return self

    async def __anext__(self) -> Any:
        return await self.recv()

    def _push(self, item: Any) -> None:
        self._inbound.put_nowait(item)


class RpcClient:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader, self._writer = reader, writer
        self._write_lock = asyncio.Lock()
        self._call_ids = itertools.count()
        self._pending: dict = {}  # call_id -> Future (unary)
        self._streams: dict = {}  # call_id -> StreamCall
        self._closed = False
        self._hello = asyncio.Event()
        self._loop_task = asyncio.create_task(self._read_loop())

    @classmethod
    async def connect(cls, host: str, port: int, *, timeout: float = 10.0) -> "RpcClient":
        reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
        client = cls(reader, writer)
        await client._send({"t": "hello", "peer_id": None})
        try:
            await asyncio.wait_for(client._hello.wait(), timeout)
        except asyncio.TimeoutError:
            await client.close()
            raise
        if client._closed:
            raise RpcError("Connection closed during handshake")
        return client

    async def _send(self, message: Any) -> None:
        if self._closed:
            raise RpcError("Client connection is closed")
        await write_frame(self._writer, message, self._write_lock)

    async def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        call_id = next(self._call_ids)
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[call_id] = future
        try:
            await self._send({"t": "req", "id": call_id, "method": method, "payload": payload})
            return await asyncio.wait_for(future, timeout)
        except (asyncio.TimeoutError, asyncio.CancelledError):
            if not self._closed:  # best effort: stop the server's work on it
                try:
                    await self._send({"t": "cancel", "id": call_id})
                except (ConnectionError, RpcError):
                    pass
            raise
        finally:
            self._pending.pop(call_id, None)

    async def open_stream(self, method: str) -> StreamCall:
        call_id = next(self._call_ids)
        stream = StreamCall(self, call_id)
        self._streams[call_id] = stream
        await self._send({"t": "sopen", "id": call_id, "method": method})
        return stream

    async def _read_loop(self) -> None:
        error: Exception = RpcError("Connection closed")
        try:
            while True:
                msg = await read_frame(self._reader)
                kind = msg.get("t")
                if kind == "hello":
                    self._hello.set()
                elif kind == "auth":
                    continue  # a server's identity proof: this client checks none
                elif kind == "resp":
                    call_id = msg["id"]
                    future = self._pending.get(call_id)
                    if msg.get("ok"):
                        if future is not None and not future.done():
                            future.set_result(msg.get("payload"))
                        continue
                    exc = RpcError(msg.get("error", "remote error"))
                    if future is not None and not future.done():
                        future.set_exception(exc)
                    stream = self._streams.pop(call_id, None)
                    if stream is not None:
                        stream._push(exc)
                elif kind == "sitem":
                    stream = self._streams.get(msg["id"])
                    if stream is not None:
                        stream._push(msg.get("payload"))
                elif kind == "send":
                    stream = self._streams.pop(msg["id"], None)
                    if stream is not None:
                        stream._push(_END)
                else:
                    logger.warning(f"Unknown frame kind {kind!r} from server")
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError) as e:
            error = RpcError(f"Connection lost: {type(e).__name__}")
        except asyncio.CancelledError:
            pass
        except Exception as e:
            logger.exception("Client read loop crashed")
            error = RpcError(f"Client read loop crashed: {e}")
        finally:
            self._closed = True
            self._hello.set()  # a connection that died mid-handshake fails connect() now
            for future in self._pending.values():
                if not future.done():
                    future.set_exception(error)
            for stream in self._streams.values():
                stream._push(error)
            self._streams.clear()

    async def close(self) -> None:
        self._closed = True
        self._loop_task.cancel()
        try:
            await self._loop_task
        except asyncio.CancelledError:
            pass
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, BrokenPipeError):
            pass
