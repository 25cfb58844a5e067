"""Run a standalone DHT bootstrap node of a swarm:

    python -m petals_tpu_torch.cli.run_dht [--host H] [--port P] [--identity_seed S]

It prints its address (``host:port/peer_id``) on a line of its own; servers
and clients pass that address as ``--initial_peers``. petals_tpu's
bootstrap node also runs a relay for servers behind NAT; this one does not
(the port has no relay yet).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

from petals_tpu_torch.dht.node import DHTNode

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
    return parser


async def start_node(args: argparse.Namespace) -> DHTNode:
    return await DHTNode.create(
        host=args.host,
        port=args.port,
        initial_peers=args.initial_peers,
        identity_seed=args.identity_seed.encode() if args.identity_seed else None,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)

    async def run():
        node = await start_node(args)
        print(node.own_addr.to_string(), flush=True)  # scripts read this line
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
            await node.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
