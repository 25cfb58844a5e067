"""Run the closed-loop swarm autoscaler against a live swarm:
``python -m petals_tpu_torch.cli.run_autoscaler --initial_peers ADDR --model PREFIX``

Joins the swarm as a query-only DHT client (a HealthMonitor without the
HTTP server), samples the announced telemetry digests every
``--interval`` seconds, and runs the deterministic policy
(:mod:`petals_tpu_torch.swarm.policy`) over the snapshots. Every decision is
journaled with its evidence (``autoscale_decision`` events; dump with
``--journal out.jsonl`` on exit).

By default the controller is ADVISORY: decisions are journaled and
printed, nothing is acted on. To close the loop, wire operator commands:

  --spawn_cmd  'systemctl start petals-replica@{start}-{end}'
  --drain_cmd  'curl -X POST http://admin/{peer}/drain'
  --resize_cmd 'curl -X POST http://admin/{peer}/resize?start={start}'

Commands are shell templates (``{start}``/``{end}``/``{peer}``
substituted) run locally with the operator's own credentials. There is
deliberately NO remote drain/spawn RPC in the swarm protocol: an
unauthenticated "please shut down" message in an open swarm is a DoS
primitive, so actuation stays an operator-side concern.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from petals_tpu_torch.utils.logging import get_logger, initialize_logs

logger = get_logger(__name__)


def _shell_callback(template: str):
    """Turn a shell template into an async actuator callback."""

    async def run(*args) -> bool:
        if len(args) == 1 and isinstance(args[0], tuple):  # scale_out(span)
            fields = {"peer": "", "start": args[0][0], "end": args[0][1]}
        elif len(args) == 1:  # scale_in(peer)
            fields = {"peer": args[0], "start": "", "end": ""}
        else:  # resize(peer, span)
            fields = {"peer": args[0], "start": args[1][0], "end": args[1][1]}
        cmd = template.format(**fields)
        logger.info(f"autoscale exec: {cmd}")
        proc = await asyncio.create_subprocess_shell(cmd)
        code = await proc.wait()
        if code != 0:
            raise RuntimeError(f"actuator command exited {code}: {cmd!r}")
        return True

    return run


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Closed-loop swarm autoscaler")
    parser.add_argument("--initial_peers", nargs="+", required=True)
    parser.add_argument("--model", required=True, help="dht_prefix of the model to scale")
    parser.add_argument("--interval", type=float, default=15.0, help="seconds per tick")
    parser.add_argument("--ttft_p99_ms", type=float, default=10_000.0)
    parser.add_argument("--queue_share_high", type=float, default=0.5)
    parser.add_argument("--queue_share_low", type=float, default=0.1)
    parser.add_argument("--sustain_out", type=int, default=2)
    parser.add_argument("--sustain_in", type=int, default=3)
    parser.add_argument("--cooldown_out", type=int, default=5)
    parser.add_argument("--cooldown_in", type=int, default=5)
    parser.add_argument("--min_replicas", type=int, default=1)
    parser.add_argument("--max_replicas", type=int, default=8)
    parser.add_argument(
        "--span_blocks", type=int, default=0,
        help="span length for spawned replicas (0 = full model)",
    )
    parser.add_argument("--spawn_cmd", help="shell template run on scale_out ({start}/{end})")
    parser.add_argument("--drain_cmd", help="shell template run on scale_in ({peer})")
    parser.add_argument("--resize_cmd", help="shell template run on resize ({peer}/{start}/{end})")
    parser.add_argument("--journal", help="write the decision journal (JSONL) here on exit")
    parser.add_argument("--max_ticks", type=int, help="stop after N ticks (default: run forever)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    initialize_logs()

    from petals_tpu_torch.swarm import Autoscaler, CallbackActuator, PolicyConfig
    from petals_tpu_torch.swarm.policy import snapshot_from_health
    from petals_tpu_torch.utils.health import HealthMonitor

    config = PolicyConfig(
        ttft_p99_ms=args.ttft_p99_ms,
        queue_share_high=args.queue_share_high,
        queue_share_low=args.queue_share_low,
        sustain_out=args.sustain_out,
        sustain_in=args.sustain_in,
        cooldown_out=args.cooldown_out,
        cooldown_in=args.cooldown_in,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        span_blocks=args.span_blocks,
    )
    actuator = CallbackActuator(
        scale_out=_shell_callback(args.spawn_cmd) if args.spawn_cmd else None,
        scale_in=_shell_callback(args.drain_cmd) if args.drain_cmd else None,
        resize=_shell_callback(args.resize_cmd) if args.resize_cmd else None,
    )
    if not (args.spawn_cmd or args.drain_cmd or args.resize_cmd):
        logger.info("No actuator commands wired: running ADVISORY (journal-only)")

    async def run() -> None:
        monitor = HealthMonitor(args.initial_peers, port=0)
        from petals_tpu_torch.dht import DHTNode

        monitor.dht = await DHTNode.create(
            initial_peers=args.initial_peers, client_mode=True
        )

        async def snapshot(tick: int):
            await monitor.refresh()
            model_state = monitor._state["models"].get(args.model)
            if model_state is None:
                logger.warning(f"model {args.model!r} not announced yet")
                return None
            return snapshot_from_health(model_state, tick=tick)

        scaler = Autoscaler(
            snapshot, actuator=actuator, config=config, interval_s=args.interval
        )
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        control = asyncio.create_task(scaler.run(max_ticks=args.max_ticks))
        try:
            stop_wait = asyncio.create_task(stop.wait())
            await asyncio.wait({control, stop_wait}, return_when=asyncio.FIRST_COMPLETED)
            stop_wait.cancel()
            control.cancel()
            try:
                await control
            except asyncio.CancelledError:
                pass
        finally:
            if args.journal:
                with open(args.journal, "w", encoding="utf-8") as f:
                    jsonl = scaler.policy.journal_jsonl()
                    f.write(jsonl + ("\n" if jsonl else ""))
                logger.info(
                    f"Wrote {len(scaler.policy.journal)} decision(s) to {args.journal}"
                )
            await monitor.dht.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
