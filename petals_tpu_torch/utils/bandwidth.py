"""Peer-to-peer bandwidth probing, the port's copy of
petals_tpu/utils/bandwidth.py. Every listening DHT node registers two probe
methods: ``net.sink`` swallows a payload (the upload direction) and
``net.source`` returns one (download). A starting server measures both
against its bootstrap peers through the real RPC stack (TCP, framing and
msgpack included), which is the bandwidth its tensors will see;
``--network_mbps`` overrides it when the operator knows the budget.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Iterable, Optional

logger = logging.getLogger(__name__)

PROBE_BYTES = 4 << 20  # per-direction payload; small enough to not disturb serving
MAX_SOURCE_BYTES = 32 << 20  # refuse to manufacture more than this per request
_WARMUP_BYTES = 1 << 16


class BandwidthProtocol:
    """Probe endpoints: ``net.sink`` swallows a payload (upload direction),
    ``net.source`` returns one (download direction)."""

    def register(self, rpc_server) -> None:
        rpc_server.add_unary_handler("net.sink", self._sink)
        rpc_server.add_unary_handler("net.source", self._source)

    async def _sink(self, payload, _ctx):
        data = (payload or {}).get("data", b"")
        return {"bytes": len(data)}

    async def _source(self, payload, _ctx):
        n = max(0, min(int((payload or {}).get("bytes", 0)), MAX_SOURCE_BYTES))
        return {"data": b"\x00" * n}


async def measure_peer_bandwidth_mbps(
    pool, addr, *, probe_bytes: int = PROBE_BYTES, timeout: float = 30.0
) -> float:
    """min(upload, download) megabits/sec to one peer through the rpc stack."""
    client = await pool.get_addr(addr)
    # warm the connection and the peer's handler path before timing
    await asyncio.wait_for(client.call("net.sink", {"data": b"\x00" * _WARMUP_BYTES}), 10.0)
    await asyncio.wait_for(client.call("net.source", {"bytes": _WARMUP_BYTES}), 10.0)

    t0 = time.perf_counter()
    await asyncio.wait_for(client.call("net.sink", {"data": b"\x00" * probe_bytes}), timeout)
    up = probe_bytes * 8 / (time.perf_counter() - t0) / 1e6

    t0 = time.perf_counter()
    reply = await asyncio.wait_for(client.call("net.source", {"bytes": probe_bytes}), timeout)
    got = len(reply.get("data", b""))
    down = got * 8 / (time.perf_counter() - t0) / 1e6 if got else 0.0
    return min(up, down)


async def probe_swarm_bandwidth_mbps(
    pool, addrs: Iterable, *, max_peers: int = 3, probe_bytes: int = PROBE_BYTES,
    per_peer_timeout: float = 45.0,
) -> Optional[float]:
    """Best min(up, down) across a few peers — the bandwidth this server can
    realistically move tensors at. Peers are probed CONCURRENTLY with a hard
    per-peer budget so one dead bootstrap address cannot stall server startup.
    None when no peer answers (callers fall back to the loopback stack probe)."""

    async def one(addr) -> Optional[float]:
        try:
            return await asyncio.wait_for(
                measure_peer_bandwidth_mbps(pool, addr, probe_bytes=probe_bytes),
                per_peer_timeout,
            )
        except Exception as e:
            logger.debug(f"Bandwidth probe to {addr} failed: {e}")
            return None

    results = await asyncio.gather(*(one(addr) for addr in list(addrs)[:max_peers]))
    measured = [m for m in results if m is not None]
    best = max(measured) if measured else None
    if best is not None:
        logger.info(f"Swarm bandwidth probe: {best:.0f} Mbit/s")
    return best
