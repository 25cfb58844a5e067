"""The port's traffic plane (petals_tpu_torch/traffic/) against
petals_tpu's: ``schedule()`` gives the same sessions for the same config
(flat prompts, prompt trees and the prefill-storm overlay), invalid
configs are refused alike, and ``run_schedule`` accounts for every session,
stubbed and against a port server."""

import dataclasses

import numpy as np
import pytest

from petals_tpu import traffic as jtraffic
from petals_tpu_torch import traffic as ptraffic

CONFIGS = {
    "default": {},
    "dense": dict(seed=42, duration_s=120.0, base_rate=2.0, wave_period_s=120.0, tenants=3, vocab_size=100),
    "flat": dict(seed=7, wave_amplitude=0.0, base_rate=1.5, tenants=1, max_new_tokens=64, pareto_alpha=1.1),
    "tree": dict(seed=3, duration_s=40.0, base_rate=1.0, shared_prefix_len=6, tree_branching=(3, 2),
                 tree_segment_len=4, tree_hot_bias=0.5, tenants=2),
    "deep_tree": dict(seed=11, duration_s=30.0, base_rate=3.0, tree_branching=(2, 2, 2), tree_segment_len=2,
                      tree_hot_bias=0.9),
    "storm": dict(seed=5, duration_s=60.0, storm_rate=0.5, storm_burst=3, storm_prompt_len=16,
                  storm_prompt_max=40),
    "storm_tree": dict(seed=9, duration_s=50.0, storm_rate=0.2, tree_branching=(2,), tree_segment_len=3,
                       shared_prefix_len=2),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_equals_petals_tpu(name):
    cfg = CONFIGS[name]
    want = jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**cfg)).schedule()
    got = ptraffic.TrafficGenerator(ptraffic.TrafficConfig(**cfg)).schedule()
    assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    assert got, "the config must schedule sessions"
    gen = ptraffic.TrafficGenerator(ptraffic.TrafficConfig(**cfg))
    assert [gen.rate_at(t) for t in (0.0, 1.5, 17.0)] == [
        jtraffic.TrafficGenerator(jtraffic.TrafficConfig(**cfg)).rate_at(t) for t in (0.0, 1.5, 17.0)
    ]


@pytest.mark.parametrize("bad", [dict(wave_amplitude=1.5), dict(base_rate=0.0), dict(tenants=0),
                                 dict(min_new_tokens=8, max_new_tokens=4)])
def test_same_config_refusals(bad):
    with pytest.raises(ValueError):
        jtraffic.TrafficConfig(**bad)
    with pytest.raises(ValueError):
        ptraffic.TrafficConfig(**bad)


def test_run_schedule_accounts_for_every_session():
    plans = [ptraffic.SessionPlan(index=i, t=0.01 * i, tenant=i % 2, prompt=(1, 2), new_tokens=2) for i in range(4)]

    def session_fn(plan):
        if plan.index == 1:
            raise RuntimeError("tenant quota")
        return plan.index * 10

    results = ptraffic.run_schedule(plans, session_fn, join_timeout_s=10.0)
    assert [r.index for r in results] == [0, 1, 2, 3]
    assert [r.ok for r in results] == [True, False, True, True]
    assert [r.value for r in results if r.ok] == [0, 20, 30]
    assert "tenant quota" in results[1].error and results[1].tenant == 1


def test_run_schedule_drives_port_sessions(tmp_path):
    """A seeded schedule, time-scaled, against a port server: every session
    completes, and its greedy tokens are the ones a lone session gives."""
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from tests.test_torch_client import Route
    from tests.utils import make_tiny_llama

    path = make_tiny_llama(str(tmp_path / "model"), n_layers=2)
    cfg = ptraffic.TrafficConfig(seed=4, duration_s=6.0, base_rate=1.0, tenants=2, prompt_prefix_len=3,
                                 prompt_suffix_len=2, vocab_size=100, min_new_tokens=2, max_new_tokens=5)
    plans = ptraffic.TrafficGenerator(cfg).schedule()
    assert len(plans) >= 3
    route = Route(path, [("port", 0, 2)], str(tmp_path / "cache"), prefix_cache_bytes=0).start()
    model = AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=route.initial_peers, device="cpu")
    try:
        def session_fn(plan):
            ids = np.asarray([plan.prompt], dtype=np.int64)
            return model.generate(ids, max_new_tokens=plan.new_tokens)

        results = ptraffic.run_schedule(plans, session_fn, time_scale=0.2, join_timeout_s=120.0)
        alone = [session_fn(plan) for plan in plans]
    finally:
        model.close()
        route.stop()
    assert [r.index for r in results] == [p.index for p in plans]
    assert all(r.ok for r in results), [r.error for r in results if not r.ok]
    for r, want in zip(results, alone):
        np.testing.assert_array_equal(r.value, want)
