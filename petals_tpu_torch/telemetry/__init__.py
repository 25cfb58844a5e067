"""The port's telemetry plane (petals_tpu/telemetry/): the metrics registry
and its named instruments, request-scoped trace ids, the scheduler event
journal, Prometheus exposition with the ``/metrics``, ``/journal`` and
``/ledger`` endpoints, the client's span waterfalls and SLO flight recorder,
the integrity observatory, the per-tenant resource ledger, the step-program
observatory (captures, replays, capture-aware kernel launch counts, and the
records and costs of the CUDA-graph step programs) and the perf-regression
gate.

The registry, instruments, journal, trace, exposition, flight, spans,
ledger and gate modules are stdlib only and copied from petals_tpu, so
both servers expose the same series; the integrity module adds numpy, and
the observatory and op_cost torch. Each package keeps its own registry, so
a process that runs a petals_tpu server and a port server counts each into
its own."""

from petals_tpu_torch.telemetry.journal import TelemetryJournal, get_journal
from petals_tpu_torch.telemetry.registry import Counter, Gauge, Histogram, MetricsRegistry, get_registry
from petals_tpu_torch.telemetry.trace import (
    current_trace_id,
    new_trace_id,
    normalize_trace_id,
    reset_trace_id,
    set_trace_id,
    trace_context,
)
from petals_tpu_torch.telemetry.exposition import MetricsServer, render_prometheus, telemetry_digest
from petals_tpu_torch.telemetry.flight import FlightRecorder, flight_from_env, http_journal_fetcher
from petals_tpu_torch.telemetry.spans import HopTrace, build_trace_report, format_waterfall
from petals_tpu_torch.telemetry.observatory import Observatory, compile_stats_digest, get_observatory
from petals_tpu_torch.telemetry.ledger import ResourceLedger, get_ledger

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "HopTrace",
    "MetricsRegistry",
    "MetricsServer",
    "Observatory",
    "ResourceLedger",
    "TelemetryJournal",
    "build_trace_report",
    "compile_stats_digest",
    "current_trace_id",
    "flight_from_env",
    "format_waterfall",
    "get_journal",
    "get_ledger",
    "get_observatory",
    "get_registry",
    "http_journal_fetcher",
    "new_trace_id",
    "normalize_trace_id",
    "render_prometheus",
    "reset_trace_id",
    "set_trace_id",
    "telemetry_digest",
    "trace_context",
]
