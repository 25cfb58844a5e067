"""SLO flight recorder: on a latency-budget breach, capture *why* (the
port's copy of petals_tpu/telemetry/flight.py).

A p99 alert tells an operator that something was slow; by the time they
look, the evidence is gone. The flight recorder watches TTFT and per-token
latency against configured SLOs and, on a breach, snapshots the evidence
that existed at that instant: the client's span waterfall
(:mod:`telemetry.spans`) plus the victim server's journal excerpt for the
breached trace_id (fetched from its ``/journal`` endpoint). Entries land in
a bounded in-memory ring, optionally written through to a JSONL file.

Breach *detection* uses monotonic deltas (the observed seconds come from
perf_counter spans); ``time.time()`` appears only as the entry's wall-clock
timestamp. A per-kind cooldown keeps a persistently slow stream from
flooding the ring with near-identical dumps.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, List, Optional

DEFAULT_MAXLEN = 64
DEFAULT_COOLDOWN_S = 5.0


class FlightRecorder:
    """Bounded ring of SLO-breach snapshots.

    ``waterfall`` / ``journal`` arguments to :meth:`observe` may be
    zero-arg callables — they are only evaluated when the observation
    actually breaches (journal fetches cost an HTTP round trip)."""

    def __init__(
        self,
        *,
        ttft_slo_s: Optional[float] = None,
        token_slo_s: Optional[float] = None,
        maxlen: int = DEFAULT_MAXLEN,
        path: Optional[str] = None,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
    ):
        self.ttft_slo_s = ttft_slo_s
        self.token_slo_s = token_slo_s
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._lock = threading.Lock()
        self._entries: collections.deque = collections.deque(maxlen=maxlen)
        self._last_breach: dict = {}  # kind -> time.monotonic() of last entry
        self._path = path
        self._sink = None
        if path:
            try:
                self._sink = open(path, "a", encoding="utf-8")
            except OSError:
                self._sink = None  # recorder stays in-memory only

    def _slo_for(self, kind: str) -> Optional[float]:
        if kind == "ttft":
            return self.ttft_slo_s
        if kind == "token":
            return self.token_slo_s
        return None

    def observe(
        self,
        kind: str,
        observed_s: float,
        *,
        trace_id: Optional[str] = None,
        waterfall=None,
        journal=None,
        **fields,
    ) -> Optional[dict]:
        """Check one latency observation against its SLO; record and return
        a breach entry, or None when within budget (the overwhelmingly
        common case — one float compare and out)."""
        slo = self._slo_for(kind)
        if slo is None or observed_s <= slo:
            return None
        now = time.monotonic()
        with self._lock:
            last = self._last_breach.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_breach[kind] = now
        entry = {
            "t": time.time(),  # wall timestamp for the operator, not a span
            "kind": kind,
            "observed_s": round(float(observed_s), 6),
            "slo_s": round(float(slo), 6),
            "trace_id": trace_id,
            **fields,
        }
        entry["waterfall"] = self._resolve(waterfall)
        entry["server_journal"] = self._resolve(journal)
        self._append(entry)
        from petals_tpu_torch.telemetry import instruments as tm

        tm.SLO_BREACHES.labels(kind=kind).inc()
        return entry

    def record(
        self,
        kind: str,
        *,
        trace_id: Optional[str] = None,
        waterfall=None,
        journal=None,
        **fields,
    ) -> Optional[dict]:
        """Record a non-latency incident unconditionally (no SLO compare) —
        e.g. a ``recompile`` anomaly from the compiled-program observatory.
        The same evidence machinery applies: lazy ``waterfall``/``journal``
        callables are resolved only when the entry is actually written, and
        the per-kind cooldown still bounds a storm of identical incidents."""
        now = time.monotonic()
        with self._lock:
            last = self._last_breach.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_breach[kind] = now
        entry = {
            "t": time.time(),  # wall timestamp for the operator, not a span
            "kind": kind,
            "trace_id": trace_id,
            **fields,
        }
        entry["waterfall"] = self._resolve(waterfall)
        entry["server_journal"] = self._resolve(journal)
        self._append(entry)
        return entry

    def _append(self, entry: dict) -> None:
        with self._lock:
            self._entries.append(entry)
            sink = self._sink
        if sink is not None:
            try:
                sink.write(json.dumps(entry, default=str) + "\n")
                sink.flush()
            except (OSError, ValueError):
                pass  # a full/closed disk must never break the request path

    @staticmethod
    def _resolve(value):
        if callable(value):
            try:
                return value()
            except Exception as e:
                # evidence collection is best-effort: a dead journal endpoint
                # must not turn a latency breach into a client error
                return {"error": repr(e)}
        return value

    def entries(self, kind: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = list(self._entries)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e, default=str) for e in self.entries())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._last_breach.clear()

    def close(self) -> None:
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.close()
            except OSError:
                pass


def http_journal_fetcher(
    base_url: str, *, timeout: float = 3.0
) -> Callable[[Optional[str]], object]:
    """Build a journal fetcher against a server's metrics endpoint: returns
    ``fetch(trace_id) -> list[event dict]`` hitting
    ``{base_url}/journal?trace_id=...`` (exposition.py serves the filtered
    ring as JSONL). stdlib-only, short timeout — evidence collection must
    not meaningfully extend an already-slow request."""
    base = base_url.rstrip("/")

    def fetch(trace_id: Optional[str] = None):
        import urllib.parse
        import urllib.request

        url = base + "/journal"
        if trace_id:
            url += "?" + urllib.parse.urlencode({"trace_id": trace_id})
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read().decode("utf-8", errors="replace")
        return [json.loads(line) for line in body.splitlines() if line.strip()]

    return fetch


def flight_from_env() -> Optional[FlightRecorder]:
    """Build a recorder from the environment, or None when no SLO is set:

    - ``PETALS_TPU_SLO_TTFT_MS``  — TTFT budget in milliseconds
    - ``PETALS_TPU_SLO_TOKEN_MS`` — per-token budget in milliseconds
    - ``PETALS_TPU_FLIGHT``       — optional JSONL write-through path
    """

    def _ms(name: str) -> Optional[float]:
        raw = os.environ.get(name)
        if not raw:
            return None
        try:
            return float(raw) / 1e3
        except ValueError:
            return None

    ttft = _ms("PETALS_TPU_SLO_TTFT_MS")
    token = _ms("PETALS_TPU_SLO_TOKEN_MS")
    if ttft is None and token is None:
        return None
    return FlightRecorder(
        ttft_slo_s=ttft,
        token_slo_s=token,
        path=os.environ.get("PETALS_TPU_FLIGHT") or None,
    )


__all__ = [
    "DEFAULT_COOLDOWN_S",
    "DEFAULT_MAXLEN",
    "FlightRecorder",
    "flight_from_env",
    "http_journal_fetcher",
]
