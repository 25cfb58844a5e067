"""Run a standalone DHT bootstrap node of a swarm:

    python -m petals_tpu_torch.cli.run_dht [--host H] [--port P] [--identity_seed S]

It prints its address (``host:port/peer_id``) on a line of its own; servers
and clients pass that address as ``--initial_peers``. As petals_tpu's, it
answers ``reach.check`` and runs a relay for servers behind NAT
(rpc/relay.py) unless ``--no_relay``: a second line ``relay host:port``
names it, which such a server passes as ``--relay_via`` (``--relay_port``
fixes its port).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import socket

from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.rpc.relay import RelayServer
from petals_tpu_torch.server.reachability import ReachabilityProtocol

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Bootstrap node of a petals_tpu swarm")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--initial_peers", nargs="*", default=[], help="Other bootstrap peers to join")
    parser.add_argument("--identity_seed", default=None,
                        help="Seed string for a deterministic peer id (a stable address)")
    parser.add_argument("--refresh_period", type=float, default=30.0,
                        help="Period of the liveness log line, seconds")
    parser.add_argument("--no_relay", action="store_true",
                        help="Do not run a relay service for NAT'd servers (rpc/relay.py)")
    parser.add_argument("--relay_port", type=int, default=0,
                        help="Listen port for the relay service (default: ephemeral)")
    return parser


def _local_ip() -> str:
    """The primary interface's address (connecting a UDP socket only picks a
    route: no packet is sent)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


async def start_node(args: argparse.Namespace) -> DHTNode:
    node = await DHTNode.create(
        host=args.host,
        port=args.port,
        initial_peers=args.initial_peers,
        identity_seed=args.identity_seed.encode() if args.identity_seed else None,
    )
    ReachabilityProtocol().register(node.server)
    return node


async def start_relay(args: argparse.Namespace, node: DHTNode) -> RelayServer:
    """The relay service, advertised in the node's method table."""
    relay = RelayServer(host=args.host, port=args.relay_port)
    await relay.start()
    relay.register_on(node.server)
    return relay


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)

    async def run():
        node = await start_node(args)
        relay = None if args.no_relay else await start_relay(args, node)
        print(node.own_addr.to_string(), flush=True)  # scripts read this line
        if relay is not None:
            # 0.0.0.0 is a listen address, not one to dial: print one an
            # operator can paste into --relay_via on another machine
            relay_host = relay.host if relay.host not in ("0.0.0.0", "::") else _local_ip()
            logger.info(f"Relay service at {relay_host}:{relay.port} (a --relay_via target)")
            print(f"relay {relay_host}:{relay.port}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            while not stop.is_set():
                try:
                    await asyncio.wait_for(stop.wait(), args.refresh_period)
                except asyncio.TimeoutError:
                    logger.info(f"Alive; routing table size: {len(node.table)}")
        finally:
            if relay is not None:
                await relay.stop()
            await node.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
