"""Prometheus-text exposition, the per-server ``/metrics`` endpoint, and
the compact digest announced to the DHT (the port's copy of
petals_tpu/telemetry/exposition.py).

Same zero-dep posture as ``utils/health.py``: the endpoint is a stdlib
``http.server.ThreadingHTTPServer`` on a daemon thread (scrapes must not
touch the serving event loop), rendering exposition format 0.0.4 by hand.
``/journal`` serves the scheduler event journal as JSONL for post-mortems,
and ``/ledger`` the per-tenant resource ledger's top-k consumer view.

``telemetry_digest()`` is the swarm-aggregation half: a tiny dict (tok/s
over the announce window, TTFT/step p50/p99, swap pressure, failure
counters) cheap enough to ride every ServerInfo announce, which
``run_health`` then aggregates across servers into ``/api/v1/metrics``.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.registry import (
    HistogramChild,
    MetricsRegistry,
    get_registry,
)

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    # HELP lines escape only backslash and newline (quotes stay literal)
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(names, values, extra: str = "") -> str:
    pairs = [f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render every registered metric in Prometheus text format 0.0.4."""
    registry = registry or get_registry()
    lines = []
    for metric in registry.collect():
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for values, child in metric.children():
            if isinstance(child, HistogramChild):
                snap = child.snapshot()
                cumulative = snap["cumulative"]
                for bound, cum in zip(snap["buckets"], cumulative):
                    le = _fmt_labels(metric.labelnames, values, f'le="{_fmt_value(bound)}"')
                    lines.append(f"{metric.name}_bucket{le} {cum}")
                inf = _fmt_labels(metric.labelnames, values, 'le="+Inf"')
                lines.append(f"{metric.name}_bucket{inf} {cumulative[-1]}")
                lbl = _fmt_labels(metric.labelnames, values)
                lines.append(f"{metric.name}_sum{lbl} {_fmt_value(snap['sum'])}")
                lines.append(f"{metric.name}_count{lbl} {snap['count']}")
            else:
                lbl = _fmt_labels(metric.labelnames, values)
                lines.append(f"{metric.name}{lbl} {_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- digest

class _RateTracker:
    """Counter → rate over the interval between digest calls (the announce
    period sets the cadence, so the published tok/s is a announce-window
    average, not an all-time mean)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_t: Optional[float] = None
        self._last_v = 0.0

    def rate(self, value: float) -> float:
        now = time.monotonic()
        with self._lock:
            last_t, last_v = self._last_t, self._last_v
            self._last_t, self._last_v = now, value
        if last_t is None or now <= last_t:
            return 0.0
        return max(0.0, (value - last_v) / (now - last_t))


_tok_rate = _RateTracker()
_handoff_rate = _RateTracker()


def telemetry_digest(registry: Optional[MetricsRegistry] = None) -> dict:
    """Compact per-server telemetry summary for the DHT announce path.

    Keys are flat and few — this dict rides every ServerInfo record, so it
    must stay small (DHT values are size-limited and widely replicated)."""
    from petals_tpu_torch.telemetry import instruments as I

    tokens = I.DECODE_TOKENS.value
    step = I.STEP_DURATION  # aggregate across variants via the snapshot
    step_count = 0
    step_sum = 0.0
    p99s = []
    for _values, child in step.children():
        snap = child.snapshot()
        step_count += snap["count"]
        step_sum += snap["sum"]
        if snap["count"]:
            p99s.append(child.quantile(0.99))
    digest = {
        "tok_s": round(_tok_rate.rate(tokens), 3),
        "tokens_total": int(tokens),
        "ttft_p50_ms": round(I.TTFT.quantile(0.5) * 1e3, 3),
        "ttft_p99_ms": round(I.TTFT.quantile(0.99) * 1e3, 3),
        "step_p99_ms": round(max(p99s) * 1e3, 3) if p99s else 0.0,
        "step_mean_ms": round(step_sum / step_count * 1e3, 3) if step_count else 0.0,
        "steps_total": int(step_count),
        "swap_out_bytes": int(I.SWAP_OUT_BYTES.value),
        "swap_in_bytes": int(I.SWAP_IN_BYTES.value),
        "preemptions": int(I.PREEMPTIONS.value),
        "alloc_failed": int(I.ALLOC_FAILED.value),
        "label_overflow": int(
            sum(c.value for _v, c in (registry or get_registry()).label_overflow.children())
        ),
        # page-pool economics: fragmentation of the paged KV pool,
        # HBM headroom, prefix-cache hit rate, oldest swap-tier resident
        "frag": round(I.PAGE_FRAGMENTATION.value, 4),
        "hbm_free_bytes": int(I.HBM_HEADROOM.value),
        "prefix_hit_rate": _prefix_hit_rate(),
        "swap_oldest_s": round(I.SWAP_RESIDENCY_OLDEST.value, 1),
        # disaggregated serving: prefill->decode KV handoff volume,
        # total and as an announce-window rate — run_health aggregates the
        # swarm's handoff bytes/s from these
        "handoff_bytes": int(I.HANDOFF_BYTES.value),
        "handoff_bytes_s": round(_handoff_rate.rate(I.HANDOFF_BYTES.value), 1),
    }
    # resource ledger: a compact per-peer usage digest so run_health
    # can rank the swarm's top consumers without scraping every /ledger
    try:
        from petals_tpu_torch.telemetry.ledger import get_ledger

        digest["ledger"] = get_ledger().digest()
    except Exception:
        pass  # the announce must never die on an accounting bug
    return digest


def _prefix_hit_rate() -> Optional[float]:
    from petals_tpu_torch.telemetry import instruments as I

    hits = I.PREFIX_HIT.value
    total = hits + I.PREFIX_MISS.value
    return round(hits / total, 4) if total else None


# ---------------------------------------------------------------- endpoint

class _MetricsHandler(BaseHTTPRequestHandler):
    server_version = "petals-tpu-metrics"

    def do_GET(self):  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        if path in ("/metrics", "/"):
            body = render_prometheus().encode()
            ctype = _CONTENT_TYPE
        elif path == "/journal":
            # server-side filters (?kind=, ?trace_id=, ?since_seq=): the
            # flight recorder asks for one trace's events, and incremental
            # scrapers poll with the last seq they saw — neither should pay
            # for (or parse) the full ring
            import urllib.parse

            params = urllib.parse.parse_qs(query)
            filters = {}
            if params.get("kind"):
                filters["kind"] = params["kind"][0]
            if params.get("trace_id"):
                filters["trace_id"] = params["trace_id"][0]
            if params.get("since_seq"):
                try:
                    filters["since_seq"] = int(params["since_seq"][0])
                except ValueError:
                    self.send_response(400)
                    self.end_headers()
                    return
            body = (get_journal().to_jsonl(**filters) + "\n").encode()
            ctype = "application/x-ndjson"
        elif path == "/compile":
            # the step-program observatory (a capture stands for a compile):
            # per-program records with the cost each capture counted;
            # ?analyze=memory (or 1) attaches what each capture measured,
            # ?fn= scopes the table to one program name
            import json as _json
            import urllib.parse

            from petals_tpu_torch.telemetry.observatory import get_observatory

            params = urllib.parse.parse_qs(query)
            want_memory = params.get("analyze", [""])[0] in ("memory", "1")
            fn_filter = params.get("fn", [""])[0] or None
            obs = get_observatory()
            view = {
                "warmup_calls": obs.warmup_calls,
                "stats": obs.compile_stats(),
                "functions": obs.functions(),
                "programs": obs.cost_table(memory=want_memory, fn=fn_filter),
                "dropped_programs": obs.dropped_programs,
            }
            body = (_json.dumps(view, default=str) + "\n").encode()
            ctype = "application/json"
        elif path == "/integrity":
            # integrity observatory view: fingerprint config (enabled, seed,
            # dim, tolerance table) plus the process-local quarantine
            # registry. Digest hexes and peer ids appear ONLY here and in
            # the journal, never as metric labels.
            import json as _json

            from petals_tpu_torch.ops import fingerprint as fp
            from petals_tpu_torch.telemetry.integrity import get_quarantine

            view = {
                "enabled": fp.enabled(),
                "fp_seed": fp.fp_seed(),
                "fp_dim": fp.FP_DIM,
                "tolerances": {
                    "exact": fp.TOL_EXACT,
                    "transport": fp.TOL_TRANSPORT,
                    "lossy_wire": fp.TOL_LOSSY_WIRE,
                    "cross_replica": {
                        q: fp.tolerance_for(q) for q in ("none", "int8", "nf4")
                    },
                },
                "quarantined": get_quarantine().snapshot(),
            }
            body = (_json.dumps(view) + "\n").encode()
            ctype = "application/json"
        elif path == "/ledger":
            # per-tenant resource ledger: top-k consumers with page-second /
            # compute-second / token / swap attribution. Peer ids appear ONLY
            # here (bounded dicts), never as metric labels — /metrics stays
            # aggregate-only per the no-unbounded-metric-labels rule.
            import json as _json
            import urllib.parse

            from petals_tpu_torch.telemetry.ledger import get_ledger

            params = urllib.parse.parse_qs(query)
            try:
                k = int(params.get("k", ["10"])[0])
            except ValueError:
                self.send_response(400)
                self.end_headers()
                return
            body = (_json.dumps(get_ledger().snapshot(k=k)) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-write; nothing to clean up

    def log_message(self, format, *args):
        pass  # scrapes every few seconds would spam the server log


class MetricsServer:
    """The per-server ``/metrics`` endpoint on a daemon thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._httpd = ThreadingHTTPServer((host, port), _MetricsHandler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="petals-tpu-metrics",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


__all__ = ["MetricsServer", "render_prometheus", "telemetry_digest"]
