"""Perf-regression gate: diff per-row telemetry blobs against a baseline
(the port's copy of petals_tpu/telemetry/gate.py).

``bench.py`` attaches a telemetry blob to every row it runs::

    {"counters_delta": {"steps_paged": 40, "decode_tokens": 80, ...},
     "step_duration": {"paged": {"count": 40, "mean_ms": 1.2,
                                 "p50_ms": 1.1, "p99_ms": 3.0}, ...}}

A committed baseline file (``BENCH_GATE_CPU.json``) records those blobs for
a known-good build; ``bench.py --gate <baseline>`` re-runs the same rows
and fails (non-zero exit) when a step-duration histogram regressed beyond
the configured tolerance, or a failure counter (alloc_failed, preemptions)
grew where the baseline had none. Durations compare *relatively* (a 2x
slower mean at tolerance 1.0 fails; CPU CI uses a wide advisory tolerance
so scheduler noise doesn't flake) with an absolute floor so sub-millisecond
jitter never trips the relative check.

The comparison is pure data->data so tests can gate synthetic blobs without
running a benchmark.
"""

from __future__ import annotations

from typing import Dict, List, Optional

DEFAULT_TOLERANCE = 1.0  # current must stay below (1 + tolerance) x the baseline
# relative checks only engage above this absolute regression (ms): CPU timers
# jitter by fractions of a millisecond, and 0.2ms -> 0.5ms is noise, not news
MIN_ABS_REGRESSION_MS = 1.0
# duration stats compared per variant; p99 excluded on purpose (one scheduler
# hiccup in a 40-step CPU row owns the p99)
_DURATION_STATS = ("mean_ms", "p50_ms")
# counters that must not grow when the baseline ran clean
# (compile_anomalies: a post-warmup recompile of a steady-state function —
# the observatory's sentinel firing during a bench row is a perf regression)
_FAILURE_COUNTERS = ("alloc_failed", "preemptions", "compile_anomalies")
# work counters that must not silently shrink (same fixed workload producing
# far fewer steps/tokens means the row no longer measures what it did)
_VOLUME_COUNTERS = ("decode_tokens",)
# budget counters: the same fixed workload must not compile MORE programs
# than the committed baseline (a bucketing bug explodes executable count
# long before it shows up in wall time). Exact comparison, no tolerance —
# compile counts are deterministic for a fixed row. Only enforced when the
# baseline recorded the key (older baselines predate the observatory).
_BUDGET_COUNTERS = ("compiles",)


def compare_step_durations(
    baseline: dict, current: dict, *, tolerance: float = DEFAULT_TOLERANCE
) -> List[str]:
    """Regressions in the per-variant step-duration summaries. A variant
    missing from ``current`` that the baseline exercised is itself a finding
    (the row stopped covering that compiled path)."""
    problems = []
    for variant, base in (baseline or {}).items():
        if not base.get("count"):
            continue
        cur = (current or {}).get(variant)
        if cur is None or not cur.get("count"):
            problems.append(
                f"step_duration[{variant}]: baseline ran {base.get('count')} steps, "
                f"current ran none (compiled path no longer exercised)"
            )
            continue
        for stat in _DURATION_STATS:
            b, c = base.get(stat), cur.get(stat)
            if b is None or c is None or b <= 0:
                continue
            # inclusive: a synthetic exactly-2x regression at tolerance 1.0
            # must fail, not ride the boundary
            if c >= b * (1.0 + tolerance) and c - b > MIN_ABS_REGRESSION_MS:
                problems.append(
                    f"step_duration[{variant}].{stat}: {c:.3f}ms vs baseline "
                    f"{b:.3f}ms ({c / b:.2f}x > {1.0 + tolerance:.2f}x allowed)"
                )
    return problems


def compare_counters(
    baseline: dict, current: dict, *, tolerance: float = DEFAULT_TOLERANCE
) -> List[str]:
    """Regressions in the per-row counter deltas: new failures where the
    baseline had none, or workload volume collapsing."""
    problems = []
    base = baseline or {}
    cur = current or {}
    for key in _FAILURE_COUNTERS:
        b, c = float(base.get(key, 0) or 0), float(cur.get(key, 0) or 0)
        if b == 0 and c > 0:
            problems.append(f"counters[{key}]: {c:g} failures vs a clean baseline")
    for key in _VOLUME_COUNTERS:
        b, c = float(base.get(key, 0) or 0), float(cur.get(key, 0) or 0)
        if b > 0 and c < b / (1.0 + tolerance):
            problems.append(
                f"counters[{key}]: {c:g} vs baseline {b:g} "
                f"(workload volume collapsed beyond {1.0 + tolerance:.2f}x)"
            )
    for key in _BUDGET_COUNTERS:
        if key not in base:
            continue  # baseline predates this counter: nothing to hold to
        b, c = float(base.get(key, 0) or 0), float(cur.get(key, 0) or 0)
        if c > b:
            problems.append(
                f"counters[{key}]: {c:g} compiled programs vs baseline {b:g} "
                f"(executable count grew — recompile or bucketing regression)"
            )
    return problems


def compare_blobs(
    baseline_blob: Optional[dict],
    current_blob: Optional[dict],
    *,
    tolerance: float = DEFAULT_TOLERANCE,
) -> List[str]:
    """All regressions of one row's telemetry blob vs its baseline blob."""
    if not baseline_blob:
        return []
    if not current_blob:
        return ["row produced no telemetry blob (baseline has one)"]
    return compare_step_durations(
        baseline_blob.get("step_duration"), current_blob.get("step_duration"),
        tolerance=tolerance,
    ) + compare_counters(
        baseline_blob.get("counters_delta"), current_blob.get("counters_delta"),
        tolerance=tolerance,
    )


def gate_report(
    baseline: dict,
    results: Dict[str, Optional[dict]],
    *,
    tolerance: Optional[float] = None,
) -> Dict[str, List[str]]:
    """Gate every baseline row against its fresh result.

    ``baseline`` is the committed gate file
    (``{"tolerance": ..., "rows": {name: {"telemetry": blob}}}``);
    ``results`` maps row name -> fresh row dict (with a ``telemetry`` key)
    or None when the row failed to run. Returns ``{row: [problem, ...]}``
    with an entry for every row that has at least one problem — empty dict
    means the gate passes."""
    tol = tolerance if tolerance is not None else float(
        baseline.get("tolerance", DEFAULT_TOLERANCE)
    )
    failures: Dict[str, List[str]] = {}
    for name, base_row in (baseline.get("rows") or {}).items():
        base_blob = (base_row or {}).get("telemetry")
        cur = results.get(name)
        if cur is None:
            failures[name] = ["row failed to run (no result)"]
            continue
        problems = compare_blobs(
            base_blob, (cur or {}).get("telemetry"), tolerance=tol
        )
        if problems:
            failures[name] = problems
    return failures


__all__ = [
    "DEFAULT_TOLERANCE",
    "MIN_ABS_REGRESSION_MS",
    "compare_blobs",
    "compare_counters",
    "compare_step_durations",
    "gate_report",
]
