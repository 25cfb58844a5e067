"""Client-side critical-path profiler: per-hop latency waterfalls.

A Petals request's latency has no single owner — it is spread across every
server of the chain plus the network between them. Servers piggyback a
compact ``step_meta`` dict (queue-wait / compute / serialize seconds, step
variant, occupancy hint) on each inference reply; the client accumulates
those into one :class:`HopTrace` per server span and
:func:`build_trace_report` turns them into a waterfall that attributes the
session's wall-clock to named components:

- ``network``  — client-observed step wall minus the server's reported
  residency (wire + framing + event-loop handoff on both ends)
- ``queue``    — time the step waited for a lane / page / compute slot
- ``compute``  — time inside the compiled device step
- ``serialize``— server-side reply serialization
- ``other``    — everything else (client-side work, server-side host ops,
  steps from old servers that sent no ``step_meta``)

The five components are exhaustive by construction, so the report's
``attributed_fraction`` is ~1.0 whenever clocks behave; the per-hop,
per-component shares are the routing/blame signal.

All durations are perf_counter/monotonic deltas — never wall clock
(the port's copy of petals_tpu/telemetry/spans.py).
"""

from __future__ import annotations

from typing import List, Optional

COMPONENTS = ("network", "queue", "compute", "serialize", "other")

# retired (failed-over / migrated-away) hop traces kept per session, so a
# report after a repair still accounts for time spent on the dead server
MAX_RETIRED_HOPS = 32


class HopTrace:
    """Accumulates one server span's per-step timing on the client side."""

    __slots__ = (
        "peer", "start_block", "end_block", "steps", "tokens",
        "wall_s", "server_s", "queue_s", "compute_s", "serialize_s",
        "meta_steps", "last_variant", "last_occupancy", "usage",
    )

    def __init__(self, peer: str, start_block: int, end_block: int):
        self.peer = peer
        self.start_block = start_block
        self.end_block = end_block
        self.steps = 0
        self.tokens = 0
        self.wall_s = 0.0  # client-observed send -> reply wall
        self.server_s = 0.0  # server-reported request residency (total_s)
        self.queue_s = 0.0
        self.compute_s = 0.0
        self.serialize_s = 0.0
        self.meta_steps = 0  # steps that carried step_meta
        self.last_variant: Optional[str] = None
        self.last_occupancy: Optional[dict] = None
        # server-billed resource usage (ledger deltas riding step_meta):
        # page_seconds / compute_seconds / tokens / swap bytes, summed
        self.usage: dict = {}

    def record(self, wall_s: float, meta: Optional[dict], tokens: int = 1) -> None:
        """Fold one step's client wall time and its (optional) server-side
        ``step_meta`` into the hop accumulators."""
        self.steps += 1
        self.tokens += max(int(tokens), 0)
        self.wall_s += max(float(wall_s), 0.0)
        if not meta:
            return
        self.meta_steps += 1
        q = float(meta.get("queue_s") or 0.0)
        c = float(meta.get("compute_s") or 0.0)
        z = float(meta.get("serialize_s") or 0.0)
        self.queue_s += q
        self.compute_s += c
        self.serialize_s += z
        # a server that reports components but no total still attributes them
        self.server_s += float(meta.get("total_s") or (q + c + z))
        if meta.get("variant"):
            self.last_variant = str(meta["variant"])
        usage = meta.get("usage")
        if isinstance(usage, dict):
            for field, amount in usage.items():
                if field in ("acceptance_rate", "tokens_per_compute_second"):
                    continue  # rates don't sum; re-derived from the counters
                try:
                    self.usage[field] = self.usage.get(field, 0) + float(amount)
                except (TypeError, ValueError):
                    continue  # a malformed server delta must not kill the step
        busy, wait = meta.get("busy_lanes"), meta.get("lane_waiters")
        if busy is not None or wait is not None:
            self.last_occupancy = {"busy_lanes": busy, "lane_waiters": wait}

    def components(self) -> dict:
        """Split this hop's client-observed wall into the five components.

        ``network`` is the residual between the client wall and the server's
        reported residency; server-side host work not covered by the three
        reported components lands in ``other``. Both are clamped at zero so
        scheduling jitter can't produce negative bars."""
        server = min(self.server_s, self.wall_s)
        network = max(self.wall_s - server, 0.0)
        known = self.queue_s + self.compute_s + self.serialize_s
        other = max(self.wall_s - network - known, 0.0)
        return {
            "network": network,
            "queue": self.queue_s,
            "compute": self.compute_s,
            "serialize": self.serialize_s,
            "other": other,
        }

    def queue_share(self) -> float:
        """Fraction of this hop's wall spent queue-waiting (routing blame)."""
        return self.queue_s / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        comps = self.components()
        wall = self.wall_s or 1e-12
        return {
            "peer": self.peer,
            "blocks": [self.start_block, self.end_block],
            "steps": self.steps,
            "meta_steps": self.meta_steps,
            "tokens": self.tokens,
            "wall_s": round(self.wall_s, 6),
            "variant": self.last_variant,
            "occupancy": self.last_occupancy,
            "components": {k: round(v, 6) for k, v in comps.items()},
            "shares": {k: round(v / wall, 4) for k, v in comps.items()},
            "usage": self._usage_dict(),
        }

    def _usage_dict(self) -> dict:
        usage = {k: round(v, 6) for k, v in self.usage.items()}
        if usage.get("spec_proposed"):
            # speculative efficiency over the hop's whole stream, derived
            # from the summed counters (rates riding individual step_meta
            # deltas would not average correctly)
            from petals_tpu_torch.telemetry.ledger import derive_efficiency

            usage.update(derive_efficiency(self.usage))
        return usage


def build_trace_report(
    trace_id: Optional[str],
    hops: List[HopTrace],
    *,
    wall_s: float,
    steps: int,
    tokens: int,
    retired_hops: int = 0,
) -> dict:
    """Assemble the per-request waterfall: per-hop component splits, swarm
    totals (client-side overhead folded into ``other``), and the single
    (hop, component) pair that dominates — the critical path."""
    hop_dicts = [h.to_dict() for h in hops]
    totals = {k: 0.0 for k in COMPONENTS}
    for h in hops:
        for k, v in h.components().items():
            totals[k] += v
    hops_wall = sum(h.wall_s for h in hops)
    # time the session spent outside any hop RPC: client-side compute
    # (sampling, embedding), inter-hop scheduling, retry backoff
    client_s = max(wall_s - hops_wall, 0.0)
    totals["other"] += client_s

    critical = None
    best = -1.0
    denom = wall_s if wall_s > 0 else 1e-12
    for h in hops:
        for comp, v in h.components().items():
            if v > best:
                best = v
                critical = {
                    "peer": h.peer,
                    "blocks": [h.start_block, h.end_block],
                    "component": comp,
                    "seconds": round(v, 6),
                    "share": round(v / denom, 4),
                }

    attributed = sum(totals.values())
    return {
        "trace_id": trace_id,
        "steps": steps,
        "tokens": tokens,
        "wall_s": round(wall_s, 6),
        "client_s": round(client_s, 6),
        "retired_hops": retired_hops,
        "hops": hop_dicts,
        "totals": {k: round(v, 6) for k, v in totals.items()},
        "critical_path": critical,
        "attributed_fraction": round(attributed / denom, 4) if wall_s > 0 else 0.0,
    }


_BAR_CHARS = {"network": "~", "queue": ".", "compute": "#", "serialize": "=", "other": " "}


def format_waterfall(report: dict, width: int = 48) -> str:
    """Render a trace report as a fixed-width ASCII waterfall (one bar per
    hop, scaled to the session wall) — the ``run_health --waterfall`` view."""
    wall = float(report.get("wall_s") or 0.0) or 1e-12
    lines = [
        f"trace {report.get('trace_id') or '?'} · {report.get('steps', 0)} steps "
        f"· {report.get('tokens', 0)} tokens · {wall:.3f} s wall"
    ]
    for hop in report.get("hops", ()):
        comps = hop.get("components", {})
        hop_wall = float(hop.get("wall_s") or 0.0)
        bar = []
        for comp in COMPONENTS:
            n = int(round(width * float(comps.get(comp, 0.0)) / wall))
            bar.append(_BAR_CHARS[comp] * n)
        blocks = hop.get("blocks") or ["?", "?"]
        shares = hop.get("shares", {})
        detail = " ".join(
            f"{comp[:3]} {100.0 * float(shares.get(comp, 0.0)):.0f}%"
            for comp in COMPONENTS
            if float(comps.get(comp, 0.0)) > 0
        )
        lines.append(
            f"  blocks [{blocks[0]},{blocks[1]}) {str(hop.get('peer', '?'))[:12]:<12} "
            f"|{''.join(bar):<{width}}| {hop_wall:.3f}s  {detail}"
        )
    crit = report.get("critical_path")
    if crit:
        lines.append(
            f"  critical path: {crit['component']} on {str(crit['peer'])[:12]} "
            f"blocks [{crit['blocks'][0]},{crit['blocks'][1]}) — "
            f"{crit['seconds']:.3f}s ({100.0 * crit['share']:.0f}% of wall)"
        )
    totals = report.get("totals")
    if totals:
        lines.append(
            "  totals: "
            + "  ".join(f"{k} {float(totals.get(k, 0.0)):.3f}s" for k in COMPONENTS)
            + f"  (attributed {100.0 * float(report.get('attributed_fraction', 0.0)):.0f}%)"
        )
    legend = "  legend: " + "  ".join(f"{c}={k}" for k, c in _BAR_CHARS.items() if k != "other")
    lines.append(legend)
    return "\n".join(lines)


__all__ = [
    "COMPONENTS",
    "MAX_RETIRED_HOPS",
    "HopTrace",
    "build_trace_report",
    "format_waterfall",
]
