"""The port's perf-regression gate (petals_tpu_torch/telemetry/gate.py)
against petals_tpu/telemetry/gate.py: the same constants and ``__all__``,
and ``compare_blobs`` / ``gate_report`` give the same problem lists for the
cases of tests/test_telemetry.py's gate tests and for seeded generated
blobs and baselines."""

import random

import pytest

from petals_tpu.telemetry import gate as jax_gate
from petals_tpu_torch.telemetry import gate

# tests/test_telemetry.py's compile-budget cases: (baseline, current)
BASE = {"counters_delta": {"compiles": 3.0, "compile_anomalies": 0.0, "decode_tokens": 40.0}}
CASES = {
    "same": (BASE, {"counters_delta": {"compiles": 3.0, "decode_tokens": 40.0}}),
    "compiles grew": (BASE, {"counters_delta": {"compiles": 5.0, "decode_tokens": 40.0}}),
    "an anomaly": (BASE, {"counters_delta": {"compiles": 3.0, "compile_anomalies": 1.0, "decode_tokens": 40.0}}),
    "a baseline before the observatory": ({"counters_delta": {"decode_tokens": 40.0}},
                                          {"counters_delta": {"compiles": 5.0, "decode_tokens": 40.0}}),
    "no baseline blob": (None, {"counters_delta": {}}),
    "no current blob": (BASE, None),
    "a variant stopped": ({"step_duration": {"paged": {"count": 40, "mean_ms": 1.0, "p50_ms": 1.0}}},
                          {"step_duration": {}}),
    "2x slower at tolerance 1": ({"step_duration": {"paged": {"count": 40, "mean_ms": 2.0, "p50_ms": 2.0}}},
                                 {"step_duration": {"paged": {"count": 40, "mean_ms": 4.0, "p50_ms": 3.9}}}),
    "sub-millisecond jitter": ({"step_duration": {"paged": {"count": 40, "mean_ms": 0.2, "p50_ms": 0.2}}},
                               {"step_duration": {"paged": {"count": 40, "mean_ms": 0.6, "p50_ms": 0.6}}}),
    "volume collapsed": ({"counters_delta": {"decode_tokens": 80.0}}, {"counters_delta": {"decode_tokens": 30.0}}),
    "failures on a clean baseline": ({"counters_delta": {"alloc_failed": 0, "preemptions": 0}},
                                     {"counters_delta": {"alloc_failed": 2, "preemptions": 1}}),
}


def test_the_gates_constants_and_names_are_the_jax_packages():
    assert gate.__all__ == jax_gate.__all__
    for name in ("DEFAULT_TOLERANCE", "MIN_ABS_REGRESSION_MS", "_DURATION_STATS", "_FAILURE_COUNTERS",
                 "_VOLUME_COUNTERS", "_BUDGET_COUNTERS"):
        assert getattr(gate, name) == getattr(jax_gate, name), name


@pytest.mark.parametrize("tolerance", [0.25, 1.0])
@pytest.mark.parametrize("case", list(CASES))
def test_compare_blobs_equals_petals_tpu(case, tolerance):
    base, cur = CASES[case]
    got = gate.compare_blobs(base, cur, tolerance=tolerance)
    assert got == jax_gate.compare_blobs(base, cur, tolerance=tolerance)
    if case in ("same", "a baseline before the observatory", "no baseline blob", "sub-millisecond jitter"):
        assert got == []
    else:
        assert got


def _blob(rng: random.Random) -> dict:
    """A seeded telemetry blob as bench.py attaches them: step durations by
    variant, some missing or empty, and counter deltas, some missing."""
    durations = {}
    for variant in ("dense", "paged", "mixed", "gen"):
        if rng.random() < 0.25:
            continue
        mean = rng.choice([0.3, 1.0, 2.5, 8.0]) * rng.uniform(0.5, 3.0)
        durations[variant] = {"count": rng.choice([0, 5, 40]), "mean_ms": mean,
                              "p50_ms": mean * rng.uniform(0.8, 1.1), "p99_ms": mean * 3}
    counters = {key: float(rng.choice([0, 0, 1, 3, 5, 40, 80]))
                for key in ("alloc_failed", "preemptions", "compile_anomalies", "decode_tokens", "compiles")
                if rng.random() < 0.8}
    return {"step_duration": durations, "counters_delta": counters}


@pytest.mark.parametrize("seed", range(20))
def test_generated_blobs_and_reports_equal_petals_tpu(seed):
    rng = random.Random(seed)
    base, cur = _blob(rng), _blob(rng)
    tolerance = rng.choice([0.1, 0.5, 1.0, 2.0])
    assert gate.compare_blobs(base, cur, tolerance=tolerance) == jax_gate.compare_blobs(base, cur,
                                                                                          tolerance=tolerance)
    rows = {f"row{i}": {"telemetry": _blob(rng) if rng.random() < 0.9 else None} for i in range(4)}
    baseline = {"tolerance": tolerance, "rows": rows}
    results = {name: ({"telemetry": _blob(rng)} if rng.random() < 0.8 else None) for name in rows}
    results.pop("row3", None)  # a row that did not run at all
    assert gate.gate_report(baseline, results) == jax_gate.gate_report(baseline, results)
    assert gate.gate_report(baseline, results, tolerance=0.3) == jax_gate.gate_report(baseline, results,
                                                                                      tolerance=0.3)
