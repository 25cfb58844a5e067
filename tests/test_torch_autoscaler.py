"""The port's autoscaler (petals_tpu_torch/swarm/) against petals_tpu's:
canned snapshot sequences (those of tests/test_autoscaler.py, and seeded
random ones) give byte-equal decision journals through both policies,
``snapshot_from_health`` reads the same digests the same way, the
controller journals and survives a failing actuator alike, the in-process
actuator moves a server, and both ``run_autoscaler`` parsers agree."""

import argparse
import asyncio
import dataclasses
import random

import pytest

import petals_tpu.swarm as jswarm
import petals_tpu_torch.swarm as pswarm
from petals_tpu.swarm.policy import snapshot_from_health as j_from_health
from petals_tpu_torch.swarm.policy import snapshot_from_health as p_from_health

PACKAGES = {"jax": jswarm, "port": pswarm}

CFG = dict(
    ttft_p99_ms=1000.0, queue_share_high=0.5, queue_share_low=0.1, sustain_out=2, sustain_in=3, cooldown_out=5,
    cooldown_in=5, cooldown_resize=10, cooldown_global=2, min_replicas=1, max_replicas=8,
)


def srv(peer, start=0, end=4, state="online", throughput=100.0, lanes=4, busy=0, waiters=0):
    return dict(peer=peer, start=start, end=end, state=state, throughput=throughput, lanes=lanes,
                busy_lanes=busy, lane_waiters=waiters)


def _day():
    hot = [srv("a", waiters=6), srv("b", throughput=50.0, busy=1)]
    cool = [srv("a"), srv("b", throughput=50.0)]
    return [(t, hot, 1500.0) for t in range(3)] + [(t, cool, 100.0) for t in range(3, 10)]


def _imbalanced():
    servers = [srv("anchor", 0, 4, throughput=10.0), srv("heavy", 0, 2, throughput=990.0, busy=1),
               srv("mover", 2, 3, throughput=40.0)]
    return [(t, servers, None) for t in range(4)]


def _sole_cover():
    servers = [srv("heavy", 0, 2, throughput=1000.0, busy=1), srv("mover", 2, 3, throughput=10.0),
               srv("tail", 3, 4, throughput=10.0, busy=1)]
    return [(t, servers, None) for t in range(5)]


def _flicker():
    warm, hot, cool = [srv("a", waiters=1)], [srv("a", waiters=4)], [srv("a")]
    return [(t, s, None) for t, s in enumerate([hot, warm, hot, warm, warm, hot, cool, hot, hot, hot, cool])]


def _max_replicas():
    many = [srv(f"r{i}", waiters=8) for i in range(8)]
    return [(t, many, 5000.0) for t in range(6)]


def _random(seed):
    rng = random.Random(seed)
    peers = [f"p{i}" for i in range(rng.randint(2, 5))]
    seq = []
    for t in range(30):
        servers = []
        for peer in peers:
            if rng.random() < 0.1:
                continue  # the server missed this tick
            start = rng.randint(0, 3)
            servers.append(srv(peer, start, rng.randint(start + 1, 4), state=rng.choice(["online"] * 5 + ["joining"]),
                               throughput=round(rng.uniform(1, 500), 3), lanes=rng.randint(1, 8),
                               busy=rng.randint(0, 2), waiters=rng.choice([0, 0, 0, 1, 3, 9])))
        seq.append((t, servers, rng.choice([None, 200.0, 1500.0, 40000.0])))
    return seq


SEQUENCES = {"day": (_day, {}), "imbalanced": (_imbalanced, dict(resize_imbalance=4.0, cooldown_resize=0)),
             "sole_cover": (_sole_cover, dict(cooldown_resize=0)), "flicker": (_flicker, {}),
             "max_replicas": (_max_replicas, dict(sustain_out=1)),
             **{f"random{s}": (lambda s=s: _random(s), dict(cooldown_resize=0, sustain_in=1)) for s in range(6)}}


def _journal(pkg, seq, overrides):
    policy = pkg.AutoscalerPolicy(pkg.PolicyConfig(**{**CFG, **overrides}))
    decisions = []
    for tick, servers, ttft in seq:
        snap = pkg.SwarmSnapshot(tick=tick, num_blocks=4, servers=tuple(pkg.ServerSample(**s) for s in servers),
                                 ttft_p99_ms=ttft)
        decisions += [d.to_journal() for d in policy.observe(snap)]
    return policy.journal_jsonl(), decisions


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_journals_are_byte_equal(name):
    build, overrides = SEQUENCES[name]
    seq = build()
    want, want_decisions = _journal(jswarm, seq, overrides)
    got, got_decisions = _journal(pswarm, seq, overrides)
    assert got == want
    assert got_decisions == want_decisions
    if name in ("day", "imbalanced"):
        assert want, "the sequence must decide something"
    if name in ("max_replicas", "sole_cover"):
        assert not want  # capped at max_replicas; never uncovers a block


HEALTH_STATES = [
    {"num_blocks": 4, "servers": {
        "good": {"state": "ONLINE", "blocks": [0, 4], "throughput": 100.0,
                 "pool": {"lanes": 2, "busy_lanes": 1, "lane_waiters": 3, "pages_free": 5, "n_pages": 9},
                 "telemetry": {"ttft_p99_ms": 250.0}, "phase_tier": "decode", "integrity": {"quarantined": True}},
        "bare": {"state": "ONLINE", "blocks": [2, 4]},
        "hostile": {"state": "ONLINE", "blocks": [0, 4], "throughput": "fast", "pool": ["not", "a", "dict"],
                    "telemetry": {"ttft_p99_ms": "slow"}},
        "not-a-dict": "garbage"}},
    {"num_blocks": 4, "servers": {
        "dead": {"state": "OFFLINE", "blocks": [0, 4], "throughput": 100.0, "pool": {"lanes": 4, "lane_waiters": 4}},
        "live": {"state": "ONLINE", "blocks": [0, 4], "throughput": 10.0, "pool": {"lanes": 2}}}},
    {"servers": {"x": {"state": "JOINING", "blocks": [1], "telemetry": {"ttft_p99_ms": True}}}},
]


@pytest.mark.parametrize("index", range(len(HEALTH_STATES)))
def test_snapshot_from_health_agrees(index):
    state = HEALTH_STATES[index]
    want = j_from_health(state, tick=3)
    got = p_from_health(state, tick=3)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.queue_share() == want.queue_share() and got.coverage() == want.coverage()


def test_snapshot_from_a_port_health_monitor_state(tmp_path):
    """The digests a port HealthMonitor builds from live port servers read
    the same through both packages' snapshot_from_health."""
    import torch

    from petals_tpu_torch.dht import DHTNode
    from petals_tpu_torch.server.server import Server
    from petals_tpu_torch.utils.health import HealthMonitor
    from tests.utils import make_tiny_llama

    path = make_tiny_llama(str(tmp_path / "model"), n_layers=4)

    async def scenario():
        boot = await DHTNode.create()
        peers = [boot.own_addr.to_string()]
        servers = [Server(path, first_block=first, num_blocks=2, initial_peers=peers, device="cpu",
                          compute_dtype=torch.float32, throughput=tp, prefix_cache_bytes=0)
                   for first, tp in ((0, 10.0), (2, 20.0))]
        for s in servers:
            await s.start()
        monitor = HealthMonitor(peers)
        monitor.dht = await DHTNode.create(initial_peers=peers, client_mode=True)
        try:
            await monitor.refresh()
            return monitor._state["models"][servers[0].dht_prefix]
        finally:
            await monitor.dht.shutdown()
            for s in servers:
                await s.shutdown()
            await boot.shutdown()

    state = asyncio.run(scenario())
    got, want = p_from_health(state, tick=0), j_from_health(state, tick=0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sorted((s.start, s.end, s.throughput) for s in got.servers) == [(0, 2, 10.0), (2, 4, 20.0)]


@pytest.mark.parametrize("pkg_name", sorted(PACKAGES))
def test_controller_journals_and_survives_actuator_failure(pkg_name):
    pkg = PACKAGES[pkg_name]
    calls = []

    def spawn(span):
        calls.append(span)
        raise RuntimeError("no capacity")

    scaler = pkg.Autoscaler(actuator=pkg.CallbackActuator(scale_out=spawn),
                            config=pkg.PolicyConfig(**{**CFG, "sustain_out": 1}))
    hot = pkg.SwarmSnapshot(tick=0, num_blocks=4, servers=(pkg.ServerSample(**srv("a", waiters=4)),))
    decisions = asyncio.run(scaler.step(hot))
    assert [d.action for d in decisions] == ["scale_out"] and calls == [(0, 4)]
    assert scaler.applied == [(decisions[0], False)]


def test_in_process_actuator_resizes_a_port_server():
    """server_actuator: a resize decision calls Server.resize on the server
    whose peer id the decision names; other actions stay advisory."""
    moved = []

    class FakeServer:
        class identity:
            class peer_id:
                @staticmethod
                def to_string():
                    return "peerA"

        async def resize(self, first):
            moved.append(first)
            return True

    actuator = pswarm.server_actuator([FakeServer()])
    resize = pswarm.Decision(tick=0, action="resize", target="peerA", span=(2, 3), reason="", evidence={})
    assert asyncio.run(actuator.apply(resize)) is True and moved == [2]
    out = pswarm.Decision(tick=0, action="scale_out", target=None, span=(0, 4), reason="", evidence={})
    assert asyncio.run(actuator.apply(out)) is False
    with pytest.raises(KeyError):
        asyncio.run(actuator.apply(dataclasses.replace(resize, target="peerB")))


def _parser_of(main, monkeypatch):
    captured = {}

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            main([])
    return captured["parser"]


def test_run_autoscaler_parsers_agree(monkeypatch):
    from petals_tpu.cli import run_autoscaler as jcli
    from petals_tpu_torch.cli import run_autoscaler as pcli

    jp, pp = _parser_of(jcli.main, monkeypatch), pcli.build_parser()

    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.required, a.nargs) for a in parser._actions}

    assert table(pp) == table(jp)
    argv = ["--initial_peers", "h:1/x", "--model", "tiny-hf", "--interval", "2", "--max_ticks", "3",
            "--resize_cmd", "echo {peer}"]
    assert vars(pp.parse_args(argv)) == vars(jp.parse_args(argv))
