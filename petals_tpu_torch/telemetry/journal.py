"""Scheduler event journal: every admission / victim / swap decision, with
the occupancy snapshot that justified it (the port's copy of
petals_tpu/telemetry/journal.py).

Post-mortems on a preempting scheduler need causality, not counters:
*which* session was evicted, by whom, and what the pool looked like at
that instant. The journal is a bounded in-memory ring of structured
events (thread-safe; the batcher emits from both the event loop and the
compute thread), dumpable as JSONL, filterable by kind/trace_id in tests,
and optionally written through to a file via ``PETALS_TPU_JOURNAL=path``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Iterator, List, Optional

DEFAULT_MAXLEN = 4096


class TelemetryJournal:
    def __init__(self, maxlen: int = DEFAULT_MAXLEN, path: Optional[str] = None):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=maxlen)
        self._seq = 0
        self._path = path
        self._sink = None
        if path:
            try:
                self._sink = open(path, "a", encoding="utf-8")
            except OSError:
                self._sink = None  # journal stays in-memory only

    def event(
        self,
        kind: str,
        *,
        trace_id: Optional[str] = None,
        lane: Optional[int] = None,
        occupancy: Optional[dict] = None,
        **fields,
    ) -> dict:
        """Record one decision. ``occupancy`` is the batcher's
        ``occupancy_info()`` dict at decision time — the justification."""
        with self._lock:
            self._seq += 1
            ev = {
                "seq": self._seq,
                "t": time.time(),
                "kind": kind,
                "trace_id": trace_id,
                "lane": lane,
                "occupancy": occupancy,
                **fields,
            }
            self._events.append(ev)
            # The write-through happens under the ring lock: two concurrent
            # writers must not interleave file lines out of seq order, or the
            # sink and the /journal export disagree about the final seq.
            if self._sink is not None:
                try:
                    self._sink.write(json.dumps(ev, default=str) + "\n")
                    self._sink.flush()
                except (OSError, ValueError):
                    pass  # a full/closed disk sink must never break serving
        return ev

    def events(
        self,
        kind: Optional[str] = None,
        trace_id: Optional[str] = None,
        since_seq: Optional[int] = None,
    ) -> List[dict]:
        """Snapshot of the ring, optionally filtered by event kind, trace id,
        and/or ``seq > since_seq`` (incremental polling: a scraper remembers
        the last seq it saw and asks only for what's new)."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if trace_id is not None:
            evs = [e for e in evs if e.get("trace_id") == trace_id]
        if since_seq is not None:
            evs = [e for e in evs if e["seq"] > since_seq]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __iter__(self) -> Iterator[dict]:
        return iter(self.events())

    def to_jsonl(self, **filters) -> str:
        return "\n".join(
            json.dumps(e, default=str) for e in self.events(**filters)
        )

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.flush()
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        """Flush and detach the write-through sink (idempotent). Called from
        ``Server.shutdown`` so the last events of a run reach disk; the ring
        itself stays usable for in-memory consumers afterwards."""
        with self._lock:
            sink, self._sink = self._sink, None
        if sink is not None:
            try:
                sink.flush()
                sink.close()
            except (OSError, ValueError):
                pass


_global_journal: Optional[TelemetryJournal] = None
_journal_lock = threading.Lock()


def get_journal() -> TelemetryJournal:
    global _global_journal
    if _global_journal is None:
        with _journal_lock:
            if _global_journal is None:
                _global_journal = TelemetryJournal(
                    path=os.environ.get("PETALS_TPU_JOURNAL") or None
                )
    return _global_journal


__all__ = ["DEFAULT_MAXLEN", "TelemetryJournal", "get_journal"]
