"""Thread-safe metrics primitives with bounded label cardinality (the
port's copy of petals_tpu/telemetry/registry.py).

Built for the batched decode tick: a ``Counter.inc`` / ``Histogram.observe``
on a pre-resolved child is one plain-``threading.Lock`` acquire plus a few
float ops (sub-microsecond on CPython) — cheap enough to live inside
``_run_batch*`` on the compute thread. Plain locks are deliberate: the
lock sanitizer (analysis/sanitizer.py) tracks only ``make_thread_lock``-built locks, and these
leaf locks guard single dict/float updates with no nesting and no awaits,
so keeping them out of the lock-order graph is correct, not evasion.

Cardinality is the classic metrics foot-gun: one ``labels(session_id=...)``
on a public swarm means unbounded memory. Every metric caps its child
series at ``max_series``; past the cap, ``labels()`` returns a shared
overflow child (all label values ``"_overflow"``) and increments
``telemetry_label_overflow_total{metric=...}`` — the error is surfaced AS
a metric, never silent growth and never an exception on a hot path.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

DEFAULT_MAX_SERIES = 64
OVERFLOW_VALUE = "_overflow"

# Latency buckets (seconds): spans 0.5ms compiled-step ticks through
# multi-second swapped-in TTFTs; +Inf is implicit.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _quantile_from_buckets(
    bounds: Sequence[float], counts: Sequence[int], total: int, q: float
) -> float:
    """Estimate a quantile from cumulative histogram buckets (linear
    interpolation within the winning bucket, Prometheus-style)."""
    if total <= 0:
        return 0.0
    target = q * total
    cumulative = 0
    lower = 0.0
    for bound, count in zip(bounds, counts):
        prev = cumulative
        cumulative += count
        if cumulative >= target:
            if count == 0:
                return bound
            frac = (target - prev) / count
            return lower + (bound - lower) * frac
        lower = bound
    return bounds[-1] if bounds else 0.0


class _Child:
    """One labeled series. Base class holds the lock and label values."""

    __slots__ = ("_lock", "label_values")

    def __init__(self, label_values: Tuple[str, ...]):
        self._lock = threading.Lock()
        self.label_values = label_values


class CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, label_values: Tuple[str, ...]):
        super().__init__(label_values)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, label_values: Tuple[str, ...]):
        super().__init__(label_values)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class HistogramChild(_Child):
    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, label_values: Tuple[str, ...], bounds: Tuple[float, ...]):
        super().__init__(label_values)
        self._bounds = bounds
        # one slot per finite bound plus the +Inf overflow slot
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if value != value or value in (math.inf, -math.inf):  # NaN/inf guard
            return
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total = self._count
            vsum = self._sum
        cumulative = []
        running = 0
        for c in counts:
            running += c
            cumulative.append(running)
        return {
            "buckets": list(self._bounds),
            "counts": counts,
            "cumulative": cumulative,
            "sum": vsum,
            "count": total,
        }

    def quantile(self, q: float) -> float:
        with self._lock:
            counts = list(self._counts)
            total = self._count
        bounds = list(self._bounds) + [self._bounds[-1] if self._bounds else 0.0]
        return _quantile_from_buckets(bounds, counts, total, q)


class _Metric:
    """A named metric family: owns its labeled children, enforces the
    series cap. ``labels()`` is get-or-create and returns a cached child —
    hot paths resolve once and keep the reference."""

    kind = "untyped"

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        labelnames: Tuple[str, ...],
        max_series: int,
    ):
        self.registry = registry
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.max_series = max_series
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._overflow_child: Optional[_Child] = None
        if not labelnames:
            # unlabeled metric: the single child IS the metric
            self._default = self._new_child(())
            self._children[()] = self._default
        else:
            self._default = None

    def _new_child(self, values: Tuple[str, ...]) -> _Child:
        raise NotImplementedError

    def labels(self, **kwargs) -> _Child:
        if set(kwargs) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(kwargs)}"
            )
        values = tuple(str(kwargs[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(values)
            if child is not None:
                return child
            if len(self._children) >= self.max_series:
                # cap reached: route to the shared overflow series and count
                # the event — memory stays bounded, the signal stays visible
                if self._overflow_child is None:
                    self._overflow_child = self._new_child(
                        tuple(OVERFLOW_VALUE for _ in self.labelnames)
                    )
                    self._children[self._overflow_child.label_values] = self._overflow_child
                overflow = self._overflow_child
            else:
                child = self._new_child(values)
                self._children[values] = child
                return child
        # outside self._lock: the overflow counter is another metric (and must
        # not count its own overflow, or this call would recurse forever)
        if self is not self.registry.label_overflow:
            self.registry.label_overflow.labels(metric=self.name).inc()
        return overflow

    def children(self) -> Iterable[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return list(self._children.items())


class Counter(_Metric):
    kind = "counter"

    def _new_child(self, values):
        return CounterChild(values)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    @property
    def value(self) -> float:
        return self._default.value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self, values):
        return GaugeChild(values)

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    @property
    def value(self) -> float:
        return self._default.value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, labelnames, max_series, buckets):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{name}: histogram needs at least one bucket bound")
        super().__init__(registry, name, help, labelnames, max_series)

    def _new_child(self, values):
        return HistogramChild(values, self.buckets)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def snapshot(self) -> dict:
        return self._default.snapshot()

    def quantile(self, q: float) -> float:
        return self._default.quantile(q)


class MetricsRegistry:
    """Get-or-create registry of named metrics. Re-registering a name with
    the same kind/labels returns the existing family (so modules can
    declare their instruments independently); a conflicting redeclaration
    is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # bootstrapped first so every other metric can report cap overflow
        self.label_overflow = Counter(
            self, "telemetry_label_overflow_total",
            "Label sets dropped to the _overflow series (cardinality cap hit)",
            ("metric",), DEFAULT_MAX_SERIES,
        )
        self._metrics[self.label_overflow.name] = self.label_overflow

    def _get_or_create(self, cls, name, help, labels, max_series, **kwargs):
        labelnames = tuple(labels)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}"
                        f"{existing.labelnames}, cannot redeclare as {cls.kind}{labelnames}"
                    )
                return existing
            metric = cls(self, name, help, labelnames, max_series, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Sequence[str] = (),
                max_series: int = DEFAULT_MAX_SERIES) -> Counter:
        return self._get_or_create(Counter, name, help, labels, max_series)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = (),
              max_series: int = DEFAULT_MAX_SERIES) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels, max_series)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  max_series: int = DEFAULT_MAX_SERIES,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labels, max_series, buckets=tuple(buckets)
        )

    def collect(self) -> Iterable[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Plain-dict view of every series (tests, digests, bench rows)."""
        out = {}
        for metric in self.collect():
            series = {}
            for values, child in metric.children():
                key = ",".join(
                    f"{n}={v}" for n, v in zip(metric.labelnames, values)
                ) or "_"
                if isinstance(child, HistogramChild):
                    series[key] = child.snapshot()
                else:
                    series[key] = child.value
            out[metric.name] = {"kind": metric.kind, "series": series}
        return out


_global_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _global_registry
    if _global_registry is None:
        with _registry_lock:
            if _global_registry is None:
                _global_registry = MetricsRegistry()
    return _global_registry


__all__ = [
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_MAX_SERIES",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "OVERFLOW_VALUE",
    "get_registry",
]
