"""Tracing and profiling hooks (the port's copy of
petals_tpu/utils/tracing.py, on ``torch.profiler`` where petals_tpu uses
``jax.profiler``).

Two layers:

- host spans: ``get_tracer().span("rpc_forward", tokens=...)`` records wall
  time and metadata into a bounded ring; ``summary()`` gives per-name
  count / p50 / p95 / total for ``rpc_info``'s ``tracing``. A span also
  opens a ``torch.profiler.record_function`` range, so the host block lines
  up with the card's kernels while a trace is captured.
- device timeline: ``start_trace(logdir)`` / ``stop_trace()`` run a
  ``torch.profiler`` capture (CPU activity, and CUDA activity through CUPTI
  when a card is present, which records the kernels of replayed CUDA
  graphs too) and write it as a Chrome trace ``trace_<pid>_<n>.json`` under
  ``logdir``. A server started with ``--trace_dir`` captures for
  ``trace_window_seconds()`` (``PETALS_TPU_TRACE_SECONDS``, default 60)
  and then writes the file: the profiler buffers every event until it
  stops. A capture stops on the thread that started it (CUPTI's callbacks
  are registered per thread). A capture that cannot start raises, so a
  server asked to trace never serves untraced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)

TRACE_DIR_ENV = "PETALS_TPU_TRACE_DIR"
TRACE_SECONDS_ENV = "PETALS_TPU_TRACE_SECONDS"
DEFAULT_TRACE_SECONDS = 60.0  # the profiler buffers until stop: bound the window
_MAX_SPANS = 2048  # ring bound: tracing must never grow server memory
_MAX_DURATIONS_PER_NAME = 4096
# span metadata bounds: a hot path passing a growing dict (or a huge repr)
# must not bloat the span ring; clipped/dropped entries are counted in the
# telemetry_meta_truncated_total metric
_MAX_META_ENTRIES = 16
_MAX_META_VALUE_LEN = 256


def _bound_meta(meta: dict) -> dict:
    """Cap entry count and value sizes; count every clip/drop."""
    truncated = 0
    out = {}
    for i, (key, value) in enumerate(meta.items()):
        if i >= _MAX_META_ENTRIES:
            truncated += len(meta) - _MAX_META_ENTRIES
            break
        if isinstance(value, (int, float, bool, type(None))):
            out[key] = value
            continue
        text = value if isinstance(value, str) else repr(value)
        if len(text) > _MAX_META_VALUE_LEN:
            text = text[:_MAX_META_VALUE_LEN]
            truncated += 1
        out[key] = text
    if truncated:
        from petals_tpu_torch.telemetry.instruments import META_TRUNCATED

        META_TRUNCATED.inc(truncated)
    return out


@dataclasses.dataclass
class Span:
    name: str
    start: float  # time.time()
    duration: float  # seconds
    meta: dict


class Tracer:
    """Thread-safe span recorder with bounded memory."""

    def __init__(self, max_spans: int = _MAX_SPANS):
        self._spans: deque = deque(maxlen=max_spans)
        self._durations: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=_MAX_DURATIONS_PER_NAME)
        )
        self._counts: Dict[str, int] = defaultdict(int)
        self._totals: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, annotate: bool = True, **meta):
        """Record one timed span; with ``annotate`` it also marks the
        profiler's timeline (``device_annotation``). Pass ``annotate=False`` when the span wraps an
        ``await`` on the event loop (concurrent spans would interleave
        non-LIFO there) and put ``device_annotation(name)`` around the actual
        compute on its worker thread instead."""
        annotation = device_annotation(name) if annotate else contextlib.nullcontext()
        # every span carries the ambient request trace id (telemetry.trace
        # contextvar) so one session's spans line up into a single timeline
        if "trace_id" not in meta:
            from petals_tpu_torch.telemetry.trace import current_trace_id

            tid = current_trace_id()
            if tid is not None:
                # first position: the entry cap trims from the END, and the
                # trace id is the one key the timeline cannot lose
                meta = {"trace_id": tid, **meta}
        meta = _bound_meta(meta)
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            with annotation:
                yield
        finally:
            duration = time.perf_counter() - t0
            with self._lock:
                self._spans.append(Span(name, t_wall, duration, meta))
                self._durations[name].append(duration)
                self._counts[name] += 1
                self._totals[name] += duration

    def recent(self, limit: int = 100) -> list:
        with self._lock:
            return list(self._spans)[-limit:]

    def summary(self) -> Dict[str, dict]:
        """Per-span-name aggregates (msgpack-safe, for rpc_info / logs)."""
        out = {}
        with self._lock:
            for name, durations in self._durations.items():
                if not durations:
                    continue
                ordered = sorted(durations)
                out[name] = {
                    "count": self._counts[name],
                    "p50_ms": round(ordered[len(ordered) // 2] * 1e3, 3),
                    "p95_ms": round(ordered[int(len(ordered) * 0.95)] * 1e3, 3),
                    "total_s": round(self._totals[name], 3),
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._durations.clear()
            self._counts.clear()
            self._totals.clear()


def device_annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name``: place it
    around the compute itself, on the thread that runs it."""
    import torch

    return torch.profiler.record_function(name)


_global_tracer: Optional[Tracer] = None
_profiler = None  # the running torch.profiler.profile, if any
_trace_path: Optional[str] = None
_trace_seq = itertools.count()
# guards the check-then-set on _profiler: two concurrent starts must not
# start two captures
_trace_lock = threading.Lock()


def get_tracer() -> Tracer:
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = Tracer()
    return _global_tracer


def start_trace(logdir: Optional[str] = None) -> Optional[str]:
    """Begin a ``torch.profiler`` capture whose Chrome trace ``stop_trace``
    writes under ``logdir`` (``PETALS_TPU_TRACE_DIR`` when None). Returns
    the path it will write, or None when no directory is set or a capture
    already runs. Raises when the profiler cannot start."""
    global _profiler, _trace_path
    logdir = logdir or os.environ.get(TRACE_DIR_ENV)
    if not logdir:
        return None
    import torch

    with _trace_lock:
        if _profiler is not None:
            return None
        os.makedirs(logdir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _profiler = prof
        _trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_trace_seq)}.json")
    logger.info(f"torch.profiler capturing to {_trace_path}")
    return _trace_path


def stop_trace() -> Optional[str]:
    """Stop the capture and write its Chrome trace; returns the path (None
    when no capture ran). Idempotent under races: concurrent stops (the
    timed flush racing shutdown) resolve to one stop."""
    global _profiler, _trace_path
    with _trace_lock:
        prof, path = _profiler, _trace_path
        if prof is None:
            return None
        # even if the stop raises, no capture is believed to run afterwards
        _profiler, _trace_path = None, None
        prof.stop()
        prof.export_chrome_trace(path)
    logger.info(f"torch.profiler trace written to {path}")
    return path


def trace_window_seconds() -> float:
    """How long a server-startup capture runs before it is written: the
    profiler buffers events until it stops, so an unbounded capture on a
    long-running server grows host memory without limit."""
    value = os.environ.get(TRACE_SECONDS_ENV, "").strip()
    return float(value) if value else DEFAULT_TRACE_SECONDS
