"""Asyncio RPC server: unary and bidirectional-streaming methods over the
framed msgpack protocol (rpc/protocol.py), the surface of
petals_tpu/rpc/server.py. Given an ``identity`` (dht/identity.py), its hello
carries its public key and a nonce, it proves its own id to a client that
sent a key and a nonce, and a client's ``auth`` proof sets
``remote_peer_id`` on the connection's context; a wrong proof closes the
connection. Without an identity, a client's ``hello`` and ``auth`` frames
are accepted and ignored, and no remote id is ever trusted."""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import secrets
import traceback
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional

from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.rpc.protocol import read_frame, write_frame

logger = logging.getLogger(__name__)

_END = object()

# Per-call inbound buffer bound: a peer stuffing frames faster than the
# handler consumes them gets its call cancelled instead of growing memory.
MAX_INBOUND_QUEUE = 128


class RpcError(Exception):
    """Raised on the caller when the remote handler failed."""


@dataclasses.dataclass
class RpcContext:
    remote_addr: tuple
    local_peer_id: Optional[PeerID] = None
    remote_peer_id: Optional[PeerID] = None  # set only once the client PROVES it


UnaryHandler = Callable[[Any, RpcContext], Awaitable[Any]]
StreamHandler = Callable[[AsyncIterator[Any], RpcContext], AsyncIterator[Any]]


class RpcServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0, *, identity=None):
        self.identity = identity
        self.peer_id: Optional[PeerID] = identity.peer_id if identity is not None else None
        self.host, self._requested_port = host, port
        self._unary: Dict[str, UnaryHandler] = {}
        self._stream: Dict[str, StreamHandler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()

    def add_unary_handler(self, method: str, fn: UnaryHandler) -> None:
        self._unary[method] = fn

    def add_stream_handler(self, method: str, fn: StreamHandler) -> None:
        self._stream[method] = fn

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_connection, self.host, self._requested_port)
        logger.debug(f"RpcServer listening on {self.host}:{self.port}")

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("server not started")
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        # cancel live connections BEFORE wait_closed(), which waits for them
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        write_lock = asyncio.Lock()
        call_tasks: Dict[int, asyncio.Task] = {}
        inbound: Dict[int, asyncio.Queue] = {}
        ctx = RpcContext(remote_addr=writer.get_extra_info("peername") or ("?", 0), local_peer_id=self.peer_id)
        handshake = _Handshake(self.identity)
        try:
            await write_frame(writer, handshake.hello(), write_lock)
            while True:
                msg = await read_frame(reader)
                kind = msg.get("t")
                if kind == "hello":
                    proof = handshake.on_client_hello(msg)
                    if proof is not None:
                        await write_frame(writer, proof, write_lock)
                elif kind == "auth":
                    if handshake.client_pub is None:
                        continue  # no identity on one side: nothing to prove
                    proven = handshake.check_client_auth(msg)
                    if proven is None:
                        logger.warning(f"Rejecting peer {ctx.remote_addr}: invalid identity proof")
                        break  # close the connection
                    ctx.remote_peer_id = proven
                elif kind == "req":
                    call_tasks[msg["id"]] = asyncio.create_task(
                        self._run_unary(msg, ctx, writer, write_lock, call_tasks)
                    )
                elif kind == "sopen":
                    queue: asyncio.Queue = asyncio.Queue(maxsize=MAX_INBOUND_QUEUE)
                    inbound[msg["id"]] = queue
                    call_tasks[msg["id"]] = asyncio.create_task(
                        self._run_stream(msg, queue, ctx, writer, write_lock, call_tasks, inbound)
                    )
                elif kind in ("sitem", "send"):
                    queue = inbound.get(msg["id"])
                    if queue is None:
                        continue
                    try:
                        queue.put_nowait(_END if kind == "send" else msg.get("payload"))
                    except asyncio.QueueFull:
                        logger.warning(f"Inbound queue overflow on call {msg['id']} from {ctx.remote_addr}")
                        stuck = call_tasks.get(msg["id"])
                        if stuck is not None:
                            stuck.cancel()
                        inbound.pop(msg["id"], None)
                        await write_frame(
                            writer,
                            {"t": "resp", "id": msg["id"], "ok": False,
                             "error": "RpcError: inbound queue overflow, call cancelled"},
                            write_lock,
                        )
                elif kind == "cancel":
                    victim = call_tasks.get(msg["id"])
                    if victim is not None:
                        victim.cancel()
                else:
                    logger.warning(f"Unknown frame kind {kind!r} from {ctx.remote_addr}")
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass  # remote disconnected
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception(f"Connection loop failed for {ctx.remote_addr}")
        finally:
            for call_task in call_tasks.values():
                call_task.cancel()
            if call_tasks:
                await asyncio.gather(*call_tasks.values(), return_exceptions=True)
            writer.close()
            self._conn_tasks.discard(task)

    async def _run_unary(self, msg, ctx, writer, write_lock, call_tasks):
        call_id = msg["id"]
        try:
            handler = self._unary.get(msg.get("method"))
            if handler is None:
                raise RpcError(f"Unknown unary method {msg.get('method')!r}")
            result = await handler(msg.get("payload"), ctx)
            await write_frame(writer, {"t": "resp", "id": call_id, "ok": True, "payload": result}, write_lock)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.debug(f"Unary {msg.get('method')} failed: {e}\n{traceback.format_exc()}")
            await _send_error(writer, write_lock, call_id, e)
        finally:
            call_tasks.pop(call_id, None)

    async def _run_stream(self, msg, queue, ctx, writer, write_lock, call_tasks, inbound):
        call_id = msg["id"]

        async def request_iter():
            while True:
                item = await queue.get()
                if item is _END:
                    return
                yield item

        try:
            handler = self._stream.get(msg.get("method"))
            if handler is None:
                raise RpcError(f"Unknown stream method {msg.get('method')!r}")
            async for item in handler(request_iter(), ctx):
                await write_frame(writer, {"t": "sitem", "id": call_id, "payload": item}, write_lock)
            await write_frame(writer, {"t": "send", "id": call_id}, write_lock)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.debug(f"Stream {msg.get('method')} failed: {e}\n{traceback.format_exc()}")
            await _send_error(writer, write_lock, call_id, e)
        finally:
            call_tasks.pop(call_id, None)
            inbound.pop(call_id, None)


async def _send_error(writer, write_lock, call_id: int, e: Exception) -> None:
    try:
        await write_frame(
            writer, {"t": "resp", "id": call_id, "ok": False, "error": f"{type(e).__name__}: {e}"},
            write_lock,
        )
    except (ConnectionError, RuntimeError):
        pass


class _Handshake:
    """The server's side of the hello challenge (petals_tpu/rpc/server.py):
    the client's hello claims an id and may send its key and a nonce; the id
    counts only once its ``auth`` frame proves the key, and this server
    proves its own id by signing the client's nonce."""

    def __init__(self, identity):
        self.identity = identity
        self.nonce = secrets.token_bytes(16)
        self.client_pub: Optional[bytes] = None
        self.client_claimed: Optional[PeerID] = None

    def hello(self) -> dict:
        ident = self.identity
        msg = {"t": "hello", "peer_id": ident.peer_id.to_string() if ident is not None else None}
        if ident is not None:
            msg["pub"] = ident.public_bytes.hex()
            msg["nonce"] = self.nonce.hex()
        return msg

    def on_client_hello(self, msg: dict) -> Optional[dict]:
        """Record the client's claim; return our proof frame when both sides
        have keys (claims are recorded, never trusted, without one)."""
        # imported here: the dht package imports the rpc modules
        from petals_tpu_torch.dht.identity import hello_challenge_message

        if self.identity is None:
            return None
        self.client_pub = bytes.fromhex(msg["pub"]) if msg.get("pub") else None
        self.client_claimed = PeerID.from_string(msg["peer_id"]) if msg.get("peer_id") else None
        if self.client_pub is None or not msg.get("nonce"):
            return None
        sig = self.identity.sign(
            hello_challenge_message(self.identity.public_bytes, self.client_pub, bytes.fromhex(msg["nonce"]))
        )
        return {"t": "auth", "sig": sig.hex()}

    def check_client_auth(self, msg: dict) -> Optional[PeerID]:
        """The client's proven peer id, or None for a wrong proof."""
        from petals_tpu_torch.dht.identity import hello_challenge_message, peer_id_of, verify

        try:
            sig = bytes.fromhex(msg.get("sig") or "")
        except ValueError:
            return None
        message = hello_challenge_message(self.client_pub, self.identity.public_bytes, self.nonce)
        proven = peer_id_of(self.client_pub)
        if verify(self.client_pub, sig, message) and self.client_claimed in (None, proven):
            return proven
        return None
