"""Connection pool: one multiplexed RpcClient per remote address, made on
demand and dropped on failure (petals_tpu/rpc/pool.py without the relay:
an address that names a relay circuit is refused until the port has one)."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict

from petals_tpu_torch.rpc.client import RpcClient
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
        key = (host, port)
        async with self._locks.setdefault(key, asyncio.Lock()):
            client = self._clients.get(key)
            if client is None or client._closed:
                client = await RpcClient.connect(host, port, identity=self.identity, timeout=self.connect_timeout)
                self._clients[key] = client
            return client

    async def get_addr(self, addr) -> RpcClient:
        """Connect to a PeerAddr (dht/routing.py)."""
        if addr.relayed:
            raise RpcError(f"{addr.to_string()} is a relay circuit; this node dials peers directly only")
        return await self.get(addr.host, addr.port)

    def invalidate(self, host: str, port: int) -> None:
        client = self._clients.pop((host, port), None)
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
