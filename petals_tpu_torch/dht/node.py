"""Kademlia DHT node over the port's asyncio RPC transport, the port's copy
of petals_tpu/dht/node.py, speaking its ``dht.*`` methods byte for byte, so
port nodes and petals_tpu nodes form one swarm:

- ``store(key, value, expiration_time, subkey=None)``: replicated to the
  ``replication`` peers nearest to sha256(key), merged per subkey with
  per-record expirations. A subkey record enters any storage, ours
  included, only when it is signed by the subkey's key holder
  (dht/identity.py).
- ``get(key)``: the local record merged with an iterative find_value.
- ``client_mode=True``: a query-only node with no listener.

One ``RpcServer`` may be shared: a model server registers its own methods
on the listener its node answers on.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.dht.identity import Identity, verify_announcement
from petals_tpu_torch.dht.routing import DEFAULT_BUCKET_SIZE, PeerAddr, RoutingTable, xor_distance
from petals_tpu_torch.dht.storage import DHTStorage, SubkeyDict
from petals_tpu_torch.rpc.pool import ConnectionPool
from petals_tpu_torch.rpc.server import RpcContext, RpcServer

logger = logging.getLogger(__name__)

DHTKey = Union[str, bytes]


def dht_time() -> float:
    """The wall clock expirations are written in."""
    return time.time()


def key_id(key: DHTKey) -> bytes:
    if isinstance(key, str):
        key = key.encode()
    return hashlib.sha256(key).digest()


class DHTNode:
    def __init__(self):
        raise RuntimeError("Use `await DHTNode.create(...)`")

    @classmethod
    async def create(
        cls,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        initial_peers: Sequence[Union[str, PeerAddr]] = (),
        identity: Optional[Identity] = None,
        identity_seed: Optional[bytes] = None,
        client_mode: bool = False,
        bucket_size: int = DEFAULT_BUCKET_SIZE,
        replication: int = 5,
        alpha: int = 3,
        rpc_server: Optional[RpcServer] = None,
        request_timeout: float = 5.0,
        maintenance_period: float = 30.0,
    ) -> "DHTNode":
        self = object.__new__(cls)
        if identity is None:
            identity = Identity.from_seed(identity_seed) if identity_seed else Identity.generate()
        self.identity = identity
        self.peer_id = identity.peer_id
        self.client_mode = client_mode
        self.replication = replication
        self.alpha = alpha
        self.request_timeout = request_timeout
        self.table = RoutingTable(self.peer_id, bucket_size)
        self.storage = DHTStorage()
        self.pool = ConnectionPool(identity=identity)
        self._owns_server = rpc_server is None and not client_mode
        self.server = None
        if not client_mode:
            self.server = rpc_server or RpcServer(host, port, identity=identity)
            self._register_handlers(self.server)
            if self._owns_server:
                await self.server.start()
        await self._bootstrap([p if isinstance(p, PeerAddr) else PeerAddr.from_string(p) for p in initial_peers])
        self._maintenance_task = asyncio.create_task(self._maintenance_loop(maintenance_period))
        return self

    # ------------------------------------------------------------------ public API

    @property
    def own_addr(self) -> Optional[PeerAddr]:
        if self.server is None:
            return None
        return PeerAddr(self.server.host, self.server.port, self.peer_id)

    async def store(self, key: DHTKey, value: Any, expiration_time: float, subkey: Optional[str] = None) -> bool:
        """Store on the nearest peers, and here if we are one of them."""
        kid = key_id(key)
        nearest = await self.find_nearest_peers(kid, k=self.replication)
        ok_any = False
        if self._stores_locally(kid, nearest) and (
            subkey is None or verify_announcement(value, subkey, expiration_time)
        ):
            ok_any = self.storage.store(kid, value, expiration_time, subkey)
        entry = [kid.hex(), subkey, value, expiration_time]
        results = await asyncio.gather(*(self._rpc_store(addr, [entry]) for addr in nearest), return_exceptions=True)
        return ok_any or any(r is True for r in results)

    async def get(self, key: DHTKey) -> Optional[Tuple[Any, float]]:
        """The latest value of ``key``: the local record merged with what the
        nearest peers hold."""
        kid = key_id(key)
        best = self.storage.get(kid)
        for candidate in await self._iterative_find_value(kid):
            best = _merge_records(best, candidate)
        return best

    async def ping(self, addr: PeerAddr) -> bool:
        try:
            client = await self.pool.get(addr.host, addr.port)
            result = await client.call("dht.ping", {"sender": self._sender_wire()}, timeout=self.request_timeout)
            self.table.add(PeerAddr(addr.host, addr.port, PeerID.from_string(result["peer_id"])))
            return True
        except Exception as e:
            logger.debug(f"ping {addr} failed: {e!r}")
            self.pool.invalidate(addr.host, addr.port)
            self.table.remove(addr.peer_id)
            return False

    async def find_nearest_peers(self, target: bytes, k: Optional[int] = None) -> List[PeerAddr]:
        """Iterative Kademlia lookup of the k peers nearest to ``target``."""
        k = k or self.replication
        target_pid = PeerID(target)
        shortlist: Dict[PeerID, PeerAddr] = {a.peer_id: a for a in self.table.nearest(target_pid, k * 2)}
        queried: set = set()
        while True:
            # pursue only unqueried peers among the k closest known: once
            # those are all queried, the lookup has converged
            k_closest = sorted(shortlist.values(), key=lambda a: xor_distance(a.peer_id, target_pid))[:k]
            candidates = [a for a in k_closest if a.peer_id not in queried][: self.alpha]
            if not candidates:
                break
            results = await asyncio.gather(*(self._rpc_find_node(a, target) for a in candidates), return_exceptions=True)
            for addr, result in zip(candidates, results):
                queried.add(addr.peer_id)
                if isinstance(result, Exception) or result is None:
                    shortlist.pop(addr.peer_id, None)
                    continue
                for peer in result:
                    if peer.peer_id != self.peer_id:
                        shortlist.setdefault(peer.peer_id, peer)
                        self.table.add(peer)
        return sorted(shortlist.values(), key=lambda a: xor_distance(a.peer_id, target_pid))[:k]

    async def shutdown(self) -> None:
        self._maintenance_task.cancel()
        try:
            await self._maintenance_task
        except asyncio.CancelledError:
            pass
        await self.pool.close()
        if self.server is not None and self._owns_server:
            await self.server.stop()

    # ------------------------------------------------------------------ RPC client side

    def _sender_wire(self) -> Optional[list]:
        addr = self.own_addr
        return addr.to_wire() if addr is not None else None

    async def _call(self, addr: PeerAddr, method: str, payload: dict):
        """One call to a peer; on failure the peer leaves the table and its
        connection is dropped, and the error propagates."""
        try:
            client = await self.pool.get(addr.host, addr.port)
            return await client.call(method, {**payload, "sender": self._sender_wire()}, timeout=self.request_timeout)
        except Exception:
            self.pool.invalidate(addr.host, addr.port)
            self.table.remove(addr.peer_id)
            raise

    async def _rpc_store(self, addr: PeerAddr, entries: List[list]) -> bool:
        if addr.peer_id == self.peer_id:
            return False  # the caller stores locally
        try:
            result = await self._call(addr, "dht.store", {"entries": entries})
        except Exception as e:
            logger.debug(f"store to {addr} failed: {e!r}")
            return False
        return any(result.get("ok", []))

    async def _rpc_find_node(self, addr: PeerAddr, target: bytes) -> Optional[List[PeerAddr]]:
        if addr.peer_id == self.peer_id:
            return []
        try:
            result = await self._call(addr, "dht.find_node", {"target": target.hex(), "k": self.replication * 2})
        except Exception as e:
            logger.debug(f"find_node at {addr} failed: {e!r}")
            return None
        return [PeerAddr.from_wire(p) for p in result.get("peers", [])]

    async def _rpc_find_value(self, addr: PeerAddr, kid: bytes) -> Optional[Tuple[Any, float]]:
        if addr.peer_id == self.peer_id:
            return None
        try:
            result = await self._call(addr, "dht.find_value", {"key": kid.hex()})
        except Exception as e:
            logger.debug(f"find_value at {addr} failed: {e!r}")
            return None
        if result.get("value") is None:
            for peer in result.get("peers", []):
                self.table.add(PeerAddr.from_wire(peer))
            return None
        value, expiration = result["value"]
        return _wire_to_record(value), expiration

    async def _iterative_find_value(self, kid: bytes) -> List[Tuple[Any, float]]:
        nearest = await self.find_nearest_peers(kid, k=self.replication)
        results = await asyncio.gather(*(self._rpc_find_value(a, kid) for a in nearest))
        return [r for r in results if r is not None]

    def _stores_locally(self, kid: bytes, nearest: List[PeerAddr]) -> bool:
        if self.client_mode:
            return False
        if len(nearest) < self.replication:
            return True
        target = PeerID(kid)
        return xor_distance(self.peer_id, target) <= xor_distance(nearest[-1].peer_id, target)

    # ------------------------------------------------------------------ RPC server side

    def _register_handlers(self, server: RpcServer) -> None:
        from petals_tpu_torch.utils.bandwidth import BandwidthProtocol

        BandwidthProtocol().register(server)  # every listening node answers probes
        server.add_unary_handler("dht.ping", self._handle_ping)
        server.add_unary_handler("dht.store", self._handle_store)
        server.add_unary_handler("dht.find_node", self._handle_find_node)
        server.add_unary_handler("dht.find_value", self._handle_find_value)

    def _note_sender(self, payload) -> None:
        sender = (payload or {}).get("sender")
        if sender:
            try:
                self.table.add(PeerAddr.from_wire(sender))
            except (ValueError, TypeError, IndexError) as e:
                logger.debug(f"ignoring a malformed sender {sender!r}: {e!r}")

    async def _handle_ping(self, payload, ctx: RpcContext):
        self._note_sender(payload)
        return {"peer_id": self.peer_id.to_string()}

    async def _handle_store(self, payload, ctx: RpcContext):
        self._note_sender(payload)
        ok = []
        for kid_hex, subkey, value, expiration in payload["entries"]:
            # a per-peer subkey record must be SIGNED by the subkey's key
            # holder: nobody overwrites another peer's announcements
            if subkey is not None and not verify_announcement(value, subkey, float(expiration)):
                logger.debug(f"Rejecting an unsigned or wrongly signed record for subkey {subkey!r}")
                ok.append(False)
                continue
            ok.append(self.storage.store(bytes.fromhex(kid_hex), value, float(expiration), subkey))
        return {"ok": ok}

    async def _handle_find_node(self, payload, ctx: RpcContext):
        self._note_sender(payload)
        target = PeerID(bytes.fromhex(payload["target"]))
        out = [p.to_wire() for p in self.table.nearest(target, int(payload.get("k", self.replication * 2)))]
        if self.own_addr is not None:
            out.append(self.own_addr.to_wire())
        return {"peers": out}

    async def _handle_find_value(self, payload, ctx: RpcContext):
        self._note_sender(payload)
        kid = bytes.fromhex(payload["key"])
        record = self.storage.get(kid)
        if record is not None:
            return {"value": [_record_to_wire(record[0]), record[1]]}
        return {"value": None, "peers": [p.to_wire() for p in self.table.nearest(PeerID(kid), self.replication * 2)]}

    # ------------------------------------------------------------------ internals

    async def _bootstrap(self, peers: List[PeerAddr]) -> None:
        if not peers:
            return
        if not any(await asyncio.gather(*(self.ping(p) for p in peers))):
            logger.warning(f"Could not reach any of {len(peers)} initial peers")
            return
        # fill the table with the peers near our own id
        await self.find_nearest_peers(self.peer_id.to_bytes(), k=self.replication)

    async def _maintenance_loop(self, period: float) -> None:
        while True:
            await asyncio.sleep(period)
            self.storage.remove_expired()


def _merge_records(a: Optional[Tuple[Any, float]], b: Optional[Tuple[Any, float]]) -> Optional[Tuple[Any, float]]:
    """Records from several peers: subkey dicts merge subkey by subkey, the
    fresher entry winning; of plain values the fresher wins."""
    if a is None:
        return b
    if b is None:
        return a
    (av, ae), (bv, be) = a, b
    if isinstance(av, SubkeyDict) and isinstance(bv, SubkeyDict):
        merged = SubkeyDict(av)
        for sk, (v, e) in bv.items():
            if sk not in merged or merged[sk][1] < e:
                merged[sk] = (v, e)
        return merged, max(ae, be)
    return a if ae >= be else b


def _record_to_wire(value: Any) -> Any:
    if isinstance(value, SubkeyDict):  # {subkey: (value, expiration)}
        return {"__subkeys__": {sk: [v, e] for sk, (v, e) in value.items()}}
    return {"__plain__": value}


def _wire_to_record(obj: Any) -> Any:
    if isinstance(obj, dict) and "__subkeys__" in obj:
        return SubkeyDict({sk: (v, e) for sk, (v, e) in obj["__subkeys__"].items()})
    if isinstance(obj, dict) and "__plain__" in obj:
        return obj["__plain__"]
    return obj
