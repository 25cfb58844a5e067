"""TCP relay for NAT'd / firewalled servers: the port's copy of
petals_tpu/rpc/relay.py, frame for frame, so a port relay serves petals_tpu
servers and clients and a petals_tpu relay serves the port's.

A server that cannot accept inbound connections keeps ONE outbound control
connection to a relay peer (any reachable peer running ``RelayServer`` — the
bootstrap DHT node by default). When someone wants to reach it:

  client ──TCP──▶ relay : {"t": "relay_dial", "target": <peer_id>}
  relay ──control──▶ hidden server : {"t": "relay_incoming", "token"}
  hidden server ──new outbound TCP──▶ relay : {"t": "relay_accept", "token"}
  relay: sends {"t": "relay_ok"} down both sockets, then splices raw bytes.

After ``relay_ok`` both ends speak the NORMAL rpc protocol end-to-end: the
hidden server runs ``RpcServer._on_connection`` on its outbound socket (a
reverse connection) and the client wraps its socket in an ``RpcClient``. The
identity handshake (hello/auth challenge-response, dht/identity.py) happens
through the splice, so a malicious relay can drop traffic but cannot
impersonate either side or inject into the authenticated session.

Registration is authenticated: the relay challenges the hidden server with a
nonce and verifies an Ed25519 signature binding pub -> peer_id, so nobody can
squat another server's relay slot and black-hole its traffic.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import secrets
from typing import Dict, Optional, Tuple

from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.rpc.protocol import read_frame, write_frame

logger = logging.getLogger(__name__)

_REGISTER_CONTEXT = b"ptu-relay-register:"
ACCEPT_TIMEOUT = 15.0
_SPLICE_CHUNK = 1 << 16


def _register_challenge(nonce: bytes, pub: bytes) -> bytes:
    return _REGISTER_CONTEXT + nonce + pub


@dataclasses.dataclass
class _Registration:
    writer: asyncio.StreamWriter
    lock: asyncio.Lock


class RelayServer:
    """Accepts registrations from hidden servers and dials from clients."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self._requested_port = host, port
        self._server: Optional[asyncio.AbstractServer] = None
        self._registered: Dict[PeerID, _Registration] = {}
        # token -> (dialer reader, dialer writer, accepted event, splice-done event)
        self._pending: Dict[str, tuple] = {}
        self._conn_tasks: set = set()

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._on_connection, self.host, self._requested_port)
        logger.debug(f"RelayServer listening on {self.host}:{self.port}")

    @property
    def port(self) -> int:
        assert self._server is not None, "relay not started"
        return self._server.sockets[0].getsockname()[1]

    def is_registered(self, peer_id: PeerID) -> bool:
        return peer_id in self._registered

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        lock = asyncio.Lock()
        registered_as: Optional[PeerID] = None
        try:
            nonce = secrets.token_bytes(16)
            await write_frame(writer, {"t": "relay_hello", "nonce": nonce.hex()}, lock)
            msg = await asyncio.wait_for(read_frame(reader), ACCEPT_TIMEOUT)
            kind = msg.get("t")
            if kind == "relay_register":
                registered_as = await self._handle_register(msg, nonce, writer, lock)
                if registered_as is not None:
                    # control loop: answer keepalives until the hidden server drops
                    while True:
                        msg = await read_frame(reader)
                        if msg.get("t") == "relay_ping":
                            await write_frame(writer, {"t": "relay_pong"}, lock)
            elif kind == "relay_dial":
                await self._handle_dial(msg, reader, writer, lock)
            elif kind == "relay_accept":
                await self._handle_accept(msg, reader, writer, lock)
            else:
                await write_frame(writer, {"t": "relay_err", "error": f"unknown {kind!r}"}, lock)
        except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError):
            pass
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("Relay connection failed")
        finally:
            if registered_as is not None and self._registered.get(registered_as, None) is not None:
                if self._registered[registered_as].writer is writer:
                    del self._registered[registered_as]
            writer.close()
            self._conn_tasks.discard(task)

    async def _handle_register(self, msg, nonce, writer, lock) -> Optional[PeerID]:
        # here, not at the top: the DHT package imports the pool, which imports this module
        from petals_tpu_torch.dht import identity as ident

        try:
            pub = bytes.fromhex(msg.get("pub") or "")
            sig = bytes.fromhex(msg.get("sig") or "")
        except ValueError:
            pub = sig = b""
        if not pub or not ident.verify(pub, sig, _register_challenge(nonce, pub)):
            await write_frame(writer, {"t": "relay_err", "error": "bad registration proof"}, lock)
            return None
        peer_id = ident.peer_id_of(pub)
        self._registered[peer_id] = _Registration(writer, lock)
        await write_frame(writer, {"t": "relay_ok"}, lock)
        logger.info(f"Relay: registered hidden server {peer_id.to_string()[:8]}…")
        return peer_id

    async def _handle_dial(self, msg, reader, writer, lock) -> None:
        try:
            target = PeerID.from_string(msg.get("target") or "")
        except Exception:
            await write_frame(writer, {"t": "relay_err", "error": "bad target"}, lock)
            return
        reg = self._registered.get(target)
        if reg is None:
            await write_frame(writer, {"t": "relay_err", "error": "target not registered"}, lock)
            return
        token = secrets.token_hex(16)
        accepted, done = asyncio.Event(), asyncio.Event()
        self._pending[token] = (reader, writer, accepted, done)
        try:
            try:
                await write_frame(reg.writer, {"t": "relay_incoming", "token": token}, reg.lock)
            except ConnectionError:
                await write_frame(writer, {"t": "relay_err", "error": "target control channel lost"}, lock)
                return
            try:
                await asyncio.wait_for(accepted.wait(), ACCEPT_TIMEOUT)
            except asyncio.TimeoutError:
                await write_frame(writer, {"t": "relay_err", "error": "target did not accept"}, lock)
                return
            # the acceptor's connection task does the splice; park here until
            # it finishes so our finally doesn't close the client socket early
            await done.wait()
        finally:
            self._pending.pop(token, None)

    async def _handle_accept(self, msg, reader, writer, lock) -> None:
        entry = self._pending.pop(msg.get("token") or "", None)
        if entry is None:
            await write_frame(writer, {"t": "relay_err", "error": "unknown token"}, lock)
            return
        dial_reader, dial_writer, accepted, done = entry
        dial_lock = asyncio.Lock()
        await write_frame(dial_writer, {"t": "relay_ok"}, dial_lock)
        await write_frame(writer, {"t": "relay_ok"}, lock)
        accepted.set()
        try:
            await asyncio.gather(
                _splice(dial_reader, writer), _splice(reader, dial_writer)
            )
        finally:
            done.set()
            dial_writer.close()

    def register_on(self, rpc_server) -> None:
        """Advertise the relay service in the host RpcServer's method table so
        peers can discover support via a cheap unary probe."""
        async def relay_info(_payload, _ctx):
            return {"host": self.host, "port": self.port}

        rpc_server.add_unary_handler("relay.info", relay_info)


async def _splice(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
    try:
        while True:
            chunk = await reader.read(_SPLICE_CHUNK)
            if not chunk:
                break
            writer.write(chunk)
            await writer.drain()
    except (ConnectionError, asyncio.IncompleteReadError):
        pass
    finally:
        try:
            writer.write_eof()
        except (OSError, RuntimeError):
            writer.close()


async def relay_dial(
    host: str, port: int, target: PeerID, timeout: float = 10.0
) -> Tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    """Client side: returns (reader, writer) spliced through the relay to the
    hidden server; the normal rpc handshake runs on top."""
    reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
    lock = asyncio.Lock()
    try:
        hello = await asyncio.wait_for(read_frame(reader), timeout)
        if hello.get("t") != "relay_hello":
            raise ConnectionError(f"not a relay (got {hello.get('t')!r})")
        await write_frame(writer, {"t": "relay_dial", "target": target.to_string()}, lock)
        ok = await asyncio.wait_for(read_frame(reader), timeout + ACCEPT_TIMEOUT)
        if ok.get("t") != "relay_ok":
            raise ConnectionError(f"relay dial failed: {ok.get('error', ok)}")
        return reader, writer
    except BaseException:
        writer.close()
        raise


class RelayRegistrar:
    """Hidden-server side: keeps a registered control connection to the relay
    and answers relay_incoming by dialing back and serving the rpc protocol
    on the reverse connection."""

    def __init__(self, relay_host: str, relay_port: int, identity, rpc_server,
                 *, keepalive: float = 30.0, retry_delay: float = 5.0):
        self.relay_host, self.relay_port = relay_host, relay_port
        self.identity = identity
        self.rpc_server = rpc_server
        self.keepalive = keepalive
        self.retry_delay = retry_delay
        self._task: Optional[asyncio.Task] = None
        self._accept_tasks: set = set()
        self.registered = asyncio.Event()

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def wait_registered(self, timeout: float = 15.0) -> None:
        await asyncio.wait_for(self.registered.wait(), timeout)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for task in list(self._accept_tasks):
            task.cancel()
        if self._accept_tasks:
            await asyncio.gather(*self._accept_tasks, return_exceptions=True)

    async def _run(self) -> None:
        while True:
            try:
                await self._register_and_serve()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning(f"Relay control connection lost ({e}); retrying in {self.retry_delay}s")
            self.registered.clear()
            await asyncio.sleep(self.retry_delay)

    async def _register_and_serve(self) -> None:
        reader, writer = await asyncio.open_connection(self.relay_host, self.relay_port)
        lock = asyncio.Lock()
        try:
            hello = await asyncio.wait_for(read_frame(reader), ACCEPT_TIMEOUT)
            nonce = bytes.fromhex(hello["nonce"])
            sig = self.identity.sign(_register_challenge(nonce, self.identity.public_bytes))
            await write_frame(
                writer,
                {"t": "relay_register", "pub": self.identity.public_bytes.hex(), "sig": sig.hex()},
                lock,
            )
            ok = await asyncio.wait_for(read_frame(reader), ACCEPT_TIMEOUT)
            if ok.get("t") != "relay_ok":
                raise ConnectionError(f"relay refused registration: {ok.get('error', ok)}")
            self.registered.set()
            loop = asyncio.get_running_loop()
            last_rx = loop.time()
            while True:
                try:
                    msg = await asyncio.wait_for(read_frame(reader), self.keepalive)
                except asyncio.TimeoutError:
                    # idle: probe the control channel instead of churning it
                    if loop.time() - last_rx > self.keepalive * 4:
                        raise ConnectionError("relay control channel went silent")
                    await write_frame(writer, {"t": "relay_ping"}, lock)
                    continue
                last_rx = loop.time()
                if msg.get("t") == "relay_incoming":
                    task = asyncio.create_task(self._accept(msg["token"]))
                    self._accept_tasks.add(task)
                    task.add_done_callback(self._accept_tasks.discard)
        finally:
            writer.close()

    async def _accept(self, token: str) -> None:
        try:
            reader, writer = await asyncio.open_connection(self.relay_host, self.relay_port)
        except OSError as e:
            logger.warning(f"Relay accept dial failed: {e}")
            return
        lock = asyncio.Lock()
        try:
            await asyncio.wait_for(read_frame(reader), ACCEPT_TIMEOUT)  # relay_hello
            await write_frame(writer, {"t": "relay_accept", "token": token}, lock)
            ok = await asyncio.wait_for(read_frame(reader), ACCEPT_TIMEOUT)
            if ok.get("t") != "relay_ok":
                raise ConnectionError(f"relay refused accept: {ok.get('error', ok)}")
        except (ConnectionError, asyncio.TimeoutError, asyncio.IncompleteReadError, KeyError) as e:
            logger.warning(f"Relay accept handshake failed: {e}")
            writer.close()
            return
        # serve the normal rpc protocol on the reverse connection; the rpc
        # server's connection loop owns the socket from here
        await self.rpc_server._on_connection(reader, writer)
