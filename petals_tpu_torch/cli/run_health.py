"""Run the swarm health monitor (the port's copy of
petals_tpu/cli/run_health.py; the health.petals.dev analogue):
``python -m petals_tpu_torch.cli.run_health --initial_peers ADDR [--host H] [--port 8799]``
Serves / (HTML), /api/v1/state (JSON), /api/v1/metrics (swarm telemetry
aggregate), /api/v1/is_reachable/<peer>.

``--waterfall TRACE.json`` instead renders a saved client trace report
(``InferenceSession.trace_report()`` dumped as JSON, or a flight-recorder
entry containing one under ``waterfall``) as an ASCII per-hop latency
waterfall and exits — no swarm connection needed.

``--top`` joins the swarm, takes one snapshot, and renders the swarm-wide
top resource consumers (per-tenant page-seconds and dominant-resource
share, merged across every server's announced ledger digest) as an ASCII
table, then exits — the ledger analogue of ``top(1)``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal

logger = logging.getLogger(__name__)


def render_waterfall_file(path: str) -> str:
    """Load a trace report (or flight-recorder entry wrapping one) and
    render it with telemetry.spans.format_waterfall."""
    from petals_tpu_torch.telemetry.spans import format_waterfall

    with open(path, "r", encoding="utf-8") as f:
        report = json.load(f)
    if "hops" not in report and isinstance(report.get("waterfall"), dict):
        report = report["waterfall"]  # a flight-recorder breach entry
    return format_waterfall(report)


def render_top(summary: dict) -> str:
    """Render a ``metrics_summary()`` dict as the swarm-wide top-consumers
    table: one section per model, tenants ranked by page-seconds."""
    lines = []
    for prefix, model in (summary.get("models") or {}).items():
        agg = model.get("aggregate") or {}
        lines.append(
            f"{prefix}: {agg.get('ledger_sessions', 0)} sessions, "
            f"{agg.get('ledger_page_s', 0.0):.1f} page-s, "
            f"{agg.get('ledger_compute_s', 0.0):.1f} compute-s, "
            f"{agg.get('noisy_neighbor_events', 0)} noisy-neighbor events"
        )
        tiers = agg.get("tiers") or {}
        if tiers.get("prefill") or tiers.get("decode"):
            # disaggregated swarm: per-tier replica split + handoff volume
            lines.append(
                f"  tiers: {tiers.get('generalist', 0)} generalist / "
                f"{tiers.get('prefill', 0)} prefill / {tiers.get('decode', 0)} decode, "
                f"handoff {agg.get('handoff_bytes', 0) / 2**20:.1f} MiB "
                f"({agg.get('handoff_bytes_s', 0.0) / 2**10:.1f} KiB/s)"
            )
        rows = agg.get("top_consumers") or []
        if not rows:
            lines.append("  (no ledger digests announced yet)")
            continue
        lines.append(f"  {'peer':<18} {'page-s':>10} {'share':>7} {'servers':>8}")
        for row in rows:
            lines.append(
                f"  {str(row.get('peer', '?')):<18} {row.get('page_s', 0.0):>10.2f} "
                f"{row.get('share_max', 0.0):>7.2f} {row.get('servers', 0):>8}"
            )
    integ = summary.get("integrity") or {}
    quarantined = integ.get("quarantined") or {}
    if quarantined:
        lines.append(
            "integrity quarantine: "
            + ", ".join(f"{p} ({why})" for p, why in sorted(quarantined.items()))
        )
    return "\n".join(lines) if lines else "(no models announced)"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Swarm health monitor")
    parser.add_argument(
        "--waterfall",
        metavar="TRACE.json",
        help="render a saved trace report as an ASCII waterfall and exit",
    )
    parser.add_argument(
        "--top",
        action="store_true",
        help="take one swarm snapshot, print the top resource consumers "
        "(per-tenant page-seconds from the servers' ledger digests), and exit",
    )
    parser.add_argument("--initial_peers", nargs="+")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8799)
    parser.add_argument("--update_period", type=float, default=15.0)
    parser.add_argument(
        "--canary_period",
        type=float,
        default=0.0,
        help="integrity canary cadence in seconds: replay seeded golden "
        "probes against every multi-replica span and quarantine fingerprint "
        "outliers by quorum (0 disables)",
    )
    args = parser.parse_args(argv)

    if args.waterfall:
        print(render_waterfall_file(args.waterfall), flush=True)
        return
    if not args.initial_peers:
        parser.error("--initial_peers is required (unless using --waterfall)")

    from petals_tpu_torch.utils.health import HealthMonitor

    if args.top:
        async def run_top():
            monitor = HealthMonitor(
                args.initial_peers, host=args.host, port=0,
                update_period=args.update_period,
            )
            from petals_tpu_torch.dht.node import DHTNode

            monitor.dht = await DHTNode.create(
                initial_peers=args.initial_peers, client_mode=True
            )
            try:
                await monitor.refresh()
                print(render_top(monitor.metrics_summary()), flush=True)
            finally:
                await monitor.dht.shutdown()

        asyncio.run(run_top())
        return

    async def run():
        monitor = HealthMonitor(
            args.initial_peers, host=args.host, port=args.port,
            update_period=args.update_period,
            canary_period=args.canary_period,
        )
        await monitor.start()
        print(f"http://{args.host}:{monitor.port}/", flush=True)
        print(f"http://{args.host}:{monitor.port}/api/v1/metrics", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await monitor.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
