"""Asyncio RPC client with connection multiplexing: the stub side of the
wire protocol (petals_tpu/rpc/client.py). One ``RpcClient`` owns one byte
stream (a TCP connection, or a relay circuit spliced by rpc/relay.py:
``from_streams``); concurrent unary calls and streams share it, matched by
call id. A lost connection fails every call in flight.

Given an ``identity``, the client's hello carries its key and a nonce, it
proves its own id to a server that advertised a key, and
``remote_peer_id`` is set once the server proves its id by signing our
nonce (``wait_authenticated``). Without one, no remote id is ever trusted."""

from __future__ import annotations

import asyncio
import itertools
import logging
import secrets
from typing import Any, AsyncIterator, Optional

from petals_tpu_torch import chaos
from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.rpc.protocol import read_frame, write_frame
from petals_tpu_torch.rpc.server import RpcError

logger = logging.getLogger(__name__)

_END = object()


class StreamCall:
    """A bidirectional stream: ``send``/``end`` feed the server, ``recv`` reads."""

    def __init__(self, client: "RpcClient", call_id: int, method: Optional[str] = None):
        self._client = client
        self._call_id = call_id
        self._method = method  # the chaos plane's detail at rpc.stream_recv
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
        if chaos.ENABLED:
            await chaos.inject(chaos.SITE_RPC_STREAM_RECV, detail=self._method)
        item = await asyncio.wait_for(self._inbound.get(), timeout)
        if item is _END:
            self._closed = True
            raise StopAsyncIteration
        if isinstance(item, Exception):
            self._closed = True
            raise item
        return item

    async def cancel(self) -> None:
        """Stop the server's handler of this stream and forget the stream."""
        if not self._closed:
            self._closed = True
            try:
                await self._client._send({"t": "cancel", "id": self._call_id})
            except (ConnectionError, RpcError):
                pass
        self._client._streams.pop(self._call_id, None)

    def __aiter__(self) -> AsyncIterator[Any]:
        return self

    async def __anext__(self) -> Any:
        return await self.recv()

    def _push(self, item: Any) -> None:
        self._inbound.put_nowait(item)


class RpcClient:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, identity=None):
        self._reader, self._writer = reader, writer
        self._identity = identity
        self._nonce = secrets.token_bytes(16)
        self._write_lock = asyncio.Lock()
        self._call_ids = itertools.count()
        self._pending: dict = {}  # call_id -> Future (unary)
        self._streams: dict = {}  # call_id -> StreamCall
        self._closed = False
        # set ONLY once the server proves its id by signing our nonce
        self.remote_peer_id: Optional[PeerID] = None
        self._server_pub: Optional[bytes] = None
        self._server_claimed: Optional[PeerID] = None
        # set once the server's hello is handled (and our proof sent), so our
        # first request never overtakes the proof
        self._hello = asyncio.Event()
        # set once the server's auth frame is handled, valid or not
        self._auth_done = asyncio.Event()
        self._loop_task = asyncio.create_task(self._read_loop())

    @classmethod
    async def connect(cls, host: str, port: int, *, identity=None, timeout: float = 10.0) -> "RpcClient":
        reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
        return await cls.from_streams(reader, writer, identity=identity, timeout=timeout)

    @classmethod
    async def from_streams(cls, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, *,
                           identity=None, timeout: float = 10.0) -> "RpcClient":
        """The handshake over a byte stream already open (a TCP connection
        or a relay splice): the hello and auth exchange is end to end."""
        client = cls(reader, writer, identity)
        hello = {"t": "hello", "peer_id": identity.peer_id.to_string() if identity is not None else None}
        if identity is not None:
            hello["pub"] = identity.public_bytes.hex()
            hello["nonce"] = client._nonce.hex()
        await client._send(hello)
        try:
            await asyncio.wait_for(client._hello.wait(), timeout)
        except asyncio.TimeoutError:
            await client.close()
            raise
        if client._closed:
            raise RpcError("Connection closed during handshake")
        return client

    async def wait_authenticated(self, timeout: float = 10.0) -> Optional[PeerID]:
        """The server's PROVEN peer id, after waiting for its proof when it
        advertised a key; None if it never proves or the proof is wrong."""
        if self._identity is None or self._server_pub is None:
            return self.remote_peer_id
        try:
            await asyncio.wait_for(self._auth_done.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        return self.remote_peer_id

    async def _on_server_hello(self, msg: dict) -> None:
        from petals_tpu_torch.dht.identity import hello_challenge_message

        self._server_pub = bytes.fromhex(msg["pub"]) if msg.get("pub") else None
        self._server_claimed = PeerID.from_string(msg["peer_id"]) if msg.get("peer_id") else None
        if self._identity is not None and self._server_pub is not None and msg.get("nonce"):
            sig = self._identity.sign(
                hello_challenge_message(self._identity.public_bytes, self._server_pub, bytes.fromhex(msg["nonce"]))
            )
            await self._send({"t": "auth", "sig": sig.hex()})
        self._hello.set()

    def _on_server_auth(self, msg: dict) -> None:
        """The server's proof: its signature over OUR key and nonce."""
        from petals_tpu_torch.dht.identity import hello_challenge_message, peer_id_of, verify

        try:
            if self._server_pub is None or self._identity is None:
                return
            try:
                sig = bytes.fromhex(msg.get("sig") or "")
            except ValueError:
                return
            message = hello_challenge_message(self._server_pub, self._identity.public_bytes, self._nonce)
            proven = peer_id_of(self._server_pub)
            if verify(self._server_pub, sig, message) and self._server_claimed in (None, proven):
                self.remote_peer_id = proven
        finally:
            self._auth_done.set()

    async def _send(self, message: Any) -> None:
        if self._closed:
            raise RpcError("Client connection is closed")
        await write_frame(self._writer, message, self._write_lock)

    async def call(self, method: str, payload: Any = None, timeout: Optional[float] = None) -> Any:
        if chaos.ENABLED:
            await chaos.inject(chaos.SITE_RPC_CALL, detail=method)
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
        if chaos.ENABLED:
            await chaos.inject(chaos.SITE_RPC_STREAM, detail=method)
        call_id = next(self._call_ids)
        stream = StreamCall(self, call_id, method)
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
                    await self._on_server_hello(msg)
                elif kind == "auth":
                    self._on_server_auth(msg)
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
            # a connection that died mid-handshake fails connect() now
            self._hello.set()
            self._auth_done.set()
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
