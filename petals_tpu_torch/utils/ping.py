"""RTT measurement of swarm peers, the port's copy of
petals_tpu/utils/ping.py: a server pings the servers that could follow it
in a chain and announces their RTTs as ``next_pings``."""

from __future__ import annotations

import asyncio
import logging
import math
import time
from typing import Dict, Sequence, Tuple

from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.rpc.pool import ConnectionPool

logger = logging.getLogger(__name__)


async def ping(
    addr: PeerAddr, pool: ConnectionPool, *, timeout: float = 5.0
) -> float:
    """RTT to a peer in seconds; math.inf on failure."""
    try:
        start = time.perf_counter()
        client = await pool.get_addr(addr)
        await asyncio.wait_for(client.call("dht.ping", {}), timeout)
        return time.perf_counter() - start
    except Exception as e:
        logger.debug(f"Ping to {addr} failed: {e}")
        return math.inf


class PingAggregator:
    """EMA-smoothed RTT table with TTL expiry (the server half of petals_tpu's;
    the jitter estimate its client routing reads waits for the client)."""

    def __init__(self, pool: ConnectionPool, *, ema_alpha: float = 0.2, expiration: float = 300.0):
        self.pool = pool
        self.ema_alpha = ema_alpha
        self.expiration = expiration
        self._rtts: Dict[PeerID, Tuple[float, float]] = {}  # peer -> (smoothed_rtt, expires_at)

    async def ping(self, addrs: Sequence[PeerAddr], *, wait_timeout: float = 5.0) -> None:
        rtts = await asyncio.gather(*(ping(a, self.pool, timeout=wait_timeout) for a in addrs))
        now = time.monotonic()
        for addr, rtt in zip(addrs, rtts):
            self._update(addr.peer_id, rtt, now)

    def _update(self, peer_id: PeerID, rtt: float, now: float) -> None:
        """Fold one raw sample into the peer's smoothed RTT."""
        prev = self._rtts.get(peer_id)
        if prev is not None and math.isfinite(prev[0]) and math.isfinite(rtt):
            rtt = self.ema_alpha * rtt + (1 - self.ema_alpha) * prev[0]
        self._rtts[peer_id] = (rtt, now + self.expiration)

    def to_dict(self) -> Dict[PeerID, float]:
        now = time.monotonic()
        return {pid: rtt for pid, (rtt, expires) in self._rtts.items() if expires > now}
