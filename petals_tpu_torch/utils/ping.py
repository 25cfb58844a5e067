"""RTT measurement of swarm peers, the port's copy of
petals_tpu/utils/ping.py: a server pings the servers that could follow it
in a chain and announces their RTTs as ``next_pings``; a client pings the
servers that could head its chain, and its router reads the smoothed RTT
(``rtt``) and the jitter estimate (``noise_s``)."""

from __future__ import annotations

import asyncio
import logging
import math
import time
from typing import Dict, Optional, Sequence, Tuple

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
    """EMA-smoothed RTT table with TTL expiry (petals_tpu/utils/ping.py:33-95).

    Also tracks a per-peer EMA of the raw samples' absolute deviation from
    the smoothed estimate: ``noise_s()`` turns that into an estimate of the
    SMOOTHED values' jitter, which sizes the router's prefix-affinity
    amplitude (client/routing/sequence_manager.py)."""

    def __init__(self, pool: ConnectionPool, *, ema_alpha: float = 0.2, expiration: float = 300.0):
        self.pool = pool
        self.ema_alpha = ema_alpha
        self.expiration = expiration
        # peer -> (smoothed_rtt, dev_ema, expires_at)
        self._rtts: Dict[PeerID, Tuple[float, float, float]] = {}

    async def ping(self, addrs: Sequence[PeerAddr], *, wait_timeout: float = 5.0) -> None:
        rtts = await asyncio.gather(*(ping(a, self.pool, timeout=wait_timeout) for a in addrs))
        now = time.monotonic()
        for addr, rtt in zip(addrs, rtts):
            self._update(addr.peer_id, rtt, now)

    def _update(self, peer_id: PeerID, rtt: float, now: Optional[float] = None) -> None:
        """Fold one raw sample into the peer's (ema, dev) state."""
        if now is None:
            now = time.monotonic()
        prev = self._rtts.get(peer_id)
        dev = 0.0
        if prev is not None and math.isfinite(prev[0]) and math.isfinite(rtt):
            # the deviation is seeded at full weight on the first pair (a
            # previous dev of 0.0 is uninitialized), so noise_s() is not
            # pinned near 0 through the client's first ping rounds
            dev = (
                abs(rtt - prev[0])
                if prev[1] == 0.0
                else self.ema_alpha * abs(rtt - prev[0]) + (1 - self.ema_alpha) * prev[1]
            )
            rtt = self.ema_alpha * rtt + (1 - self.ema_alpha) * prev[0]
        self._rtts[peer_id] = (rtt, dev, now + self.expiration)

    def to_dict(self) -> Dict[PeerID, float]:
        now = time.monotonic()
        return {pid: rtt for pid, (rtt, _dev, expires) in self._rtts.items() if expires > now}

    def rtt(self, peer_id: Optional[PeerID], default: float = 0.01) -> float:
        """Smoothed RTT for routing edges (``default`` when unknown)."""
        if peer_id is None:
            return default
        entry = self._rtts.get(peer_id)
        if entry is None or entry[2] <= time.monotonic() or not math.isfinite(entry[0]):
            return default
        return entry[0]

    def noise_s(self) -> float:
        """Estimated standard deviation of the SMOOTHED RTTs, from the median
        per-peer raw deviation EMA: for gaussian jitter mean |raw - ema| is
        ~0.8 sigma_raw, and the EMA's own variance is sigma_raw^2 * a/(2-a),
        so sigma_ema ~ dev/0.8 * sqrt(a/(2-a)). 0 when nothing is measured."""
        now = time.monotonic()
        devs = sorted(
            dev for (rtt, dev, expires) in self._rtts.values()
            if expires > now and math.isfinite(rtt)
        )
        if not devs:
            return 0.0
        median = devs[len(devs) // 2]
        return median / 0.8 * math.sqrt(self.ema_alpha / (2 - self.ema_alpha))
