"""Reachability checking: can other peers dial us back? (the port's copy
of petals_tpu/server/reachability.py). Every port server and bootstrap
registers ``reach.check``: the callee dials the address it is given and
reports whether the peer there proved the id the address names.
``check_direct_reachability`` asks a few peers to do that for us.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional, Sequence

from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.rpc.client import RpcClient
from petals_tpu_torch.rpc.server import RpcContext, RpcServer
from petals_tpu_torch.utils.random_utils import sample_up_to

logger = logging.getLogger(__name__)


class ReachabilityProtocol:
    """Registers ``reach.check`` on a node's RPC server: the callee dials the
    requested address back and reports success."""

    def __init__(self, *, probe_timeout: float = 5.0, identity=None):
        self.probe_timeout = probe_timeout
        # probing WITH an identity makes the target prove ITS identity back,
        # so a stale host:port reused by a different peer is detected
        self.identity = identity

    def register(self, server: RpcServer) -> None:
        if self.identity is None:
            self.identity = server.identity
        server.add_unary_handler("reach.check", self.rpc_check)

    async def rpc_check(self, payload, ctx: RpcContext):
        addr = PeerAddr.from_string(payload["addr"])
        try:
            deadline = asyncio.get_running_loop().time() + self.probe_timeout
            client = await asyncio.wait_for(
                RpcClient.connect(addr.host, addr.port, identity=self.identity),
                self.probe_timeout,
            )
            if self.identity is not None:
                # authenticated probe: the endpoint must PROVE the claimed id.
                # The whole probe shares ONE probe_timeout budget, so the reply
                # lands inside the asking peer's RPC timeout even when the
                # target accepts TCP but never proves (a definitive False beats
                # a dropped vote).
                remaining = max(deadline - asyncio.get_running_loop().time(), 0.1)
                proven = await client.wait_authenticated(remaining)
                ok = proven == addr.peer_id
            else:
                ok = client.remote_peer_id == addr.peer_id or client.remote_peer_id is None
            await client.close()
            return {"reachable": bool(ok)}
        except Exception as e:
            return {"reachable": False, "reason": f"{type(e).__name__}: {e}"}


async def check_direct_reachability(
    dht: DHTNode, *, max_peers: int = 3, threshold: float = 0.5
) -> Optional[bool]:
    """Ask a few peers to dial us back (reference server.py:137-150 decides
    client-mode/relay from this). None = inconclusive (nobody to ask)."""
    own = dht.own_addr
    if own is None:
        return None
    peers: Sequence[PeerAddr] = dht.table.all_peers()
    peers = sample_up_to(peers, max_peers)
    if not peers:
        return None
    results = []
    for peer in peers:
        try:
            client = await dht.pool.get(peer.host, peer.port)
            reply = await asyncio.wait_for(
                client.call("reach.check", {"addr": own.to_string()}), 10.0
            )
            results.append(bool(reply.get("reachable")))
        except Exception as e:
            # a peer we cannot even ask is itself a (neutral) data point
            logger.debug("reachability probe via %s failed: %r", peer, e)
            continue
    if not results:
        return None
    return sum(results) / len(results) >= threshold
