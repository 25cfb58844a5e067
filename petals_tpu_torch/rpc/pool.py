"""Connection pool: one multiplexed RpcClient per remote address, made on
demand and dropped on failure (petals_tpu/rpc/pool.py). An address that
names a relay circuit (``relay+host:port/peer``, a server behind NAT) is
dialed through the relay (rpc/relay.py), and the circuit is kept only when
the far end PROVES the peer id the address names."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, Optional

from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.rpc.client import RpcClient
from petals_tpu_torch.rpc.relay import relay_dial
from petals_tpu_torch.rpc.server import RpcError

logger = logging.getLogger(__name__)


class ConnectionPool:
    def __init__(self, connect_timeout: float = 10.0, identity=None):
        self.identity = identity  # dht/identity.py Identity: proves our peer id in hellos
        self.connect_timeout = connect_timeout
        self._clients: Dict[tuple, RpcClient] = {}
        self._locks: Dict[tuple, asyncio.Lock] = {}
        # strong refs to background closes (the loop holds tasks weakly)
        self._bg_closes: set = set()

    async def get(self, host: str, port: int) -> RpcClient:
        return await self._get((host, port, None))

    async def get_addr(self, addr) -> RpcClient:
        """Connect to a PeerAddr (dht/routing.py): directly, or through its
        relay when it names a relay circuit (``addr.relayed``)."""
        return await self._get((addr.host, addr.port, addr.peer_id if addr.relayed else None))

    async def _get(self, key: tuple) -> RpcClient:
        host, port, relay_target = key
        async with self._locks.setdefault(key, asyncio.Lock()):
            client = self._clients.get(key)
            if client is not None and not client._closed:
                return client
            if relay_target is None:
                client = await RpcClient.connect(host, port, identity=self.identity, timeout=self.connect_timeout)
            else:
                client = await self._dial_relayed(host, port, relay_target)
            self._clients[key] = client
            return client

    async def _dial_relayed(self, host: str, port: int, target: PeerID) -> RpcClient:
        if self.identity is None:
            # without our identity the far end proves nothing, and a
            # malicious relay could splice us to any registered server
            raise RpcError("Relay circuits require an identity (mutual auth)")
        reader, writer = await relay_dial(host, port, target, timeout=self.connect_timeout)
        client = await RpcClient.from_streams(reader, writer, identity=self.identity, timeout=self.connect_timeout)
        proven = await client.wait_authenticated(self.connect_timeout)
        if proven != target:
            # the relay spliced us to some OTHER (or unproven) peer
            await client.close()
            raise RpcError(f"Relay handed us {proven}, expected {target}")
        return client

    def invalidate(self, host: str, port: int) -> None:
        for key in [k for k in self._clients if k[0] == host and k[1] == port]:
            client = self._clients.pop(key, None)
            if client is not None:
                # close in the background: callers are synchronous
                task = asyncio.ensure_future(self._close_quietly(client))
                self._bg_closes.add(task)
                task.add_done_callback(self._bg_closes.discard)

    @staticmethod
    async def _close_quietly(client: RpcClient) -> None:
        try:
            await client.close()
        except Exception as e:
            logger.debug(f"closing a dropped connection failed: {e!r}")

    async def close(self) -> None:
        clients, self._clients = list(self._clients.values()), {}
        for client in clients:
            await self._close_quietly(client)
