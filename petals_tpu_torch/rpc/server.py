"""Asyncio RPC server: unary and bidirectional-streaming methods over the
framed msgpack protocol (rpc/protocol.py), the surface of
petals_tpu/rpc/server.py without the identity handshake. A client's
``hello`` and ``auth`` frames are accepted and ignored, as petals_tpu's
server does when it has no identity of its own."""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import traceback
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional

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


UnaryHandler = Callable[[Any, RpcContext], Awaitable[Any]]
StreamHandler = Callable[[AsyncIterator[Any], RpcContext], AsyncIterator[Any]]


class RpcServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
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
        ctx = RpcContext(remote_addr=writer.get_extra_info("peername") or ("?", 0))
        try:
            await write_frame(writer, {"t": "hello", "peer_id": None}, write_lock)
            while True:
                msg = await read_frame(reader)
                kind = msg.get("t")
                if kind in ("hello", "auth"):
                    continue  # no identity here: claims are neither checked nor trusted
                if kind == "req":
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
