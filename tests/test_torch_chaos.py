"""The port's chaos plane (petals_tpu_torch/chaos/) against petals_tpu's:
the same spec and seed give the same decisions and the same fired log, the
same specs are refused, ``corrupt_array`` flips the same components, every
site fires in the port's code, and a port session survives a dropped stream
open and a failed step with the stream a petals_tpu swarm gives.

Each package's plane is global to its process: every test disarms both on
the way out."""

import asyncio
import time

import numpy as np
import pytest
import torch

from petals_tpu import chaos as jchaos
from petals_tpu_torch import chaos
from petals_tpu_torch.chaos import ChaosInjected, ChaosPlane, ChaosRule
from tests.test_torch_client import Route
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(autouse=True)
def _disarm_chaos():
    chaos.disable()
    jchaos.disable()
    yield
    chaos.disable()
    jchaos.disable()


SPECS = [
    "seed=42;rpc.call:drop:0.3;handler.step:delay:0.5:0.01;migrate.push:refuse:::3",
    "seed=7;dht.announce:drop:0.5;dht.lookup:drop:0.2:0:4;swap.reserve:refuse:0.7",
    "seed=0;integrity.corrupt:corrupt:0.25::2;rpc.stream_open:drop:0.5;rpc.stream_recv:kill:0.1",
    "seed=123456;handoff.push:delay:0.9:0.2;rpc.call:refuse",
]


@pytest.mark.parametrize("spec", SPECS)
def test_same_seed_same_decisions_and_log(spec):
    seed, rules = chaos.parse_spec(spec)
    jseed, jrules = jchaos.parse_spec(spec)
    assert seed == jseed
    assert [(r.site, r.action, r.p, r.delay_s, r.max_count) for r in rules] == [
        (r.site, r.action, r.p, r.delay_s, r.max_count) for r in jrules
    ]
    plane, jplane = ChaosPlane(seed=seed, rules=rules), jchaos.ChaosPlane(seed=jseed, rules=jrules)
    arrivals = np.random.RandomState(seed % 2**31).randint(0, len(chaos.SITES), 400)
    for i, k in enumerate(arrivals):
        site, detail = chaos.SITES[k], f"d{i % 7}"
        a, b = plane.decide(site, detail), jplane.decide(site, detail)
        assert (a and a.action) == (b and b.action), (i, site)
    assert plane.fired() == jplane.fired()
    assert plane.fired()  # the spec fired at all
    assert [r.count for r in plane.rules] == [r.count for r in jplane.rules]


@pytest.mark.parametrize(
    "spec",
    [
        "nosuchsite:drop",
        "rpc.call:explode",
        "rpc.call",
        "rpc.call:drop:1.5",
        "rpc.call:drop:0.5:-1",
        "rpc.call:drop:0.5:0.1:2:extra",
        "integrity.corrupt:corrupt:7",
        "integrity.corrupted:corrupt",
        "rpc.call:drop:x",
    ],
)
def test_same_grammar_rejections(spec):
    with pytest.raises(ValueError):
        jchaos.parse_spec(spec)
    with pytest.raises(ValueError):
        chaos.parse_spec(spec)


def test_env_spec_arms_the_lazy_flag(monkeypatch):
    assert chaos.ENABLED is False and chaos.get_plane() is None
    monkeypatch.setenv("PETALS_TPU_CHAOS", "seed=7;dht.announce:drop:0.5")
    chaos.plane._arm_from_env()
    # the package's ENABLED is read through to the plane module: live
    assert chaos.ENABLED and chaos.get_plane().seed == 7
    chaos.disable()
    assert chaos.ENABLED is False


@pytest.mark.parametrize("plane_seed,site_seed,position", [(0, 0, 0), (3, 12345, 17), (99, 0xFFFFFFFF, 4096)])
@pytest.mark.parametrize("width", [16, 64, 200])
def test_corrupt_array_equals_petals_tpu(plane_seed, site_seed, position, width):
    chaos.configure(seed=plane_seed)
    jchaos.configure(seed=plane_seed)
    x = np.random.RandomState(width).standard_normal((1, 3, width)).astype(np.float32)
    want = jchaos.corrupt_array(x, site_seed, position)
    np.testing.assert_array_equal(chaos.corrupt_array(x, site_seed, position), want)
    # a bfloat16 tensor on the host: a sign flip is exact, so the same bits
    t = torch.from_numpy(x).to(torch.bfloat16)
    got = chaos.corrupt_array(t, site_seed, position)
    np.testing.assert_array_equal(got.float().numpy(), jchaos.corrupt_array(t.float().numpy(), site_seed, position))
    assert not np.array_equal(want, x) and np.array_equal(want[:, :-1], x[:, :-1])


# ------------------------------------------------------------ sites in the port


def test_site_rpc_call_and_stream_open_fire_before_the_wire():
    from petals_tpu_torch.rpc.client import RpcClient

    plane = chaos.configure(rules=[ChaosRule(chaos.SITE_RPC_CALL, "drop", match="ptu.info", max_count=1),
                                   ChaosRule(chaos.SITE_RPC_STREAM, "refuse", max_count=1)])
    client = RpcClient.__new__(RpcClient)  # never reaches its connection

    async def scenario():
        with pytest.raises(ChaosInjected):
            await client.call("ptu.info", {})
        with pytest.raises(ChaosInjected):
            await client.open_stream("ptu.inference")

    asyncio.run(scenario())
    assert [(e["site"], e["detail"]) for e in plane.fired()] == [
        (chaos.SITE_RPC_CALL, "ptu.info"), (chaos.SITE_RPC_STREAM, "ptu.inference"),
    ]


def test_site_stream_recv_injects_mid_stream():
    from petals_tpu_torch.rpc.client import StreamCall

    plane = chaos.configure(rules=[
        ChaosRule(chaos.SITE_RPC_STREAM_RECV, "drop", match="ptu.inference", max_count=1),
        ChaosRule(chaos.SITE_RPC_STREAM_RECV, "delay", delay_s=0.05, match="ptu.other", max_count=1),
    ])

    async def scenario():
        stream = StreamCall(client=None, call_id=1, method="ptu.inference")
        stream._push({"step": 0})
        with pytest.raises(ChaosInjected):
            await stream.recv(timeout=1.0)
        assert await stream.recv(timeout=1.0) == {"step": 0}
        other = StreamCall(client=None, call_id=2, method="ptu.other")
        other._push({"step": 1})
        t0 = time.monotonic()
        assert await other.recv(timeout=1.0) == {"step": 1}
        assert time.monotonic() - t0 >= 0.04

    asyncio.run(scenario())
    assert [e["action"] for e in plane.fired(chaos.SITE_RPC_STREAM_RECV)] == ["drop", "delay"]


def test_site_dht_lookup_fails_route_discovery():
    from petals_tpu_torch.utils.dht_utils import get_remote_module_infos

    plane = chaos.configure(rules=[ChaosRule(chaos.SITE_DHT_LOOKUP, "drop", max_count=1)])

    async def scenario():
        with pytest.raises(ChaosInjected):
            await get_remote_module_infos(None, ["tiny.0", "tiny.1"])  # before the node is touched

    asyncio.run(scenario())
    assert [e["detail"] for e in plane.fired(chaos.SITE_DHT_LOOKUP)] == ["tiny.0"]


def test_site_swap_reserve_refuses_budget():
    from petals_tpu_torch.server.memory_cache import HostSwapPool
    from petals_tpu_torch.telemetry import instruments as tm

    child = tm.CHAOS_INJECTIONS.labels(site=chaos.SITE_SWAP_RESERVE, action="refuse")
    before = child.value
    pool = HostSwapPool(max_size_bytes=1 << 20)
    assert pool.try_reserve(1024)
    chaos.configure(rules=[ChaosRule(chaos.SITE_SWAP_RESERVE, "refuse", max_count=1)])
    assert not pool.try_reserve(1024)
    assert pool.stats["rejected"] == 1
    assert pool.try_reserve(1024)
    assert pool.bytes_in_use == 2048
    assert child.value - before == 1  # the port's own registry counts the firing


# ------------------------------------------------------------ a port swarm


@pytest.fixture(scope="module")
def swarms(tmp_path_factory):
    """Two port servers over tiny-llama's whole span, and the greedy streams
    a one-server petals_tpu swarm gives for the prompts below."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    path = make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=4)
    cache = str(tmp_path_factory.mktemp("cache"))
    jax_route = Route(path, [("jax", 0, 4)], cache).start()
    jax_model = JaxClient.from_pretrained(path, initial_peers=jax_route.initial_peers)
    try:
        expected = {seed: jax_model.generate(_prompt(seed), max_new_tokens=6) for seed in (3, 4)}
    finally:
        jax_model.close()
        jax_route.stop()
    route = Route(
        path, [("port", 0, 4, dict(throughput=1000.0)), ("port", 0, 4, dict(throughput=1.0))], cache,
        server_side_generation=False,  # the per-token path: each step crosses handler.step
    ).start()
    yield path, route, expected
    route.stop()


def _prompt(seed):
    return np.random.RandomState(seed).randint(0, 100, (1, 5 + seed % 2)).astype(np.int64)


@pytest.fixture()
def port_model(swarms):
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM

    path, route, _ = swarms
    model = AutoDistributedModelForCausalLM.from_pretrained(
        path, initial_peers=route.initial_peers, device="cpu", min_backoff=0.1, ban_timeout=1.0,
    )
    yield model
    model.close()


def test_session_survives_dropped_stream_open(swarms, port_model):
    _, _, expected = swarms
    plane = chaos.configure(seed=11, rules=[ChaosRule(chaos.SITE_RPC_STREAM, "drop", max_count=1)])
    out = port_model.generate(_prompt(3), max_new_tokens=6)
    assert len(plane.fired(chaos.SITE_RPC_STREAM)) == 1, "the fault must fire"
    np.testing.assert_array_equal(out, expected[3])


def test_session_survives_mid_step_failure(swarms, port_model):
    _, _, expected = swarms
    ids = _prompt(4)
    with port_model.remote.inference_session(max_length=16, batch_size=1) as session:
        first = port_model.generate(ids, max_new_tokens=3, session=session)
        np.testing.assert_array_equal(first, expected[4][:, : ids.shape[1] + 3])
        plane = chaos.configure(seed=12, rules=[ChaosRule(chaos.SITE_HANDLER_STEP, "drop", max_count=1)])
        final = port_model.generate(first, max_new_tokens=3, session=session)
    assert len(plane.fired(chaos.SITE_HANDLER_STEP)) == 1, "the fault must fire"
    np.testing.assert_array_equal(final, expected[4])


def test_sites_announce_probe_and_push_fire_in_a_server(swarms):
    """dht.announce drops the announce, integrity.corrupt changes the probe's
    digest for the matched replica only, migrate.push fails the push inside
    its deadline (the entry stays parked)."""
    from petals_tpu_torch.data_structures import ServerState

    _, route, _ = swarms
    a, b = route.servers
    run = route.loop.run
    honest = run(a.handler.rpc_probe({"seed": 5, "tokens": 4}, None))["fp"]
    plane = chaos.configure(seed=2, rules=[
        ChaosRule(chaos.SITE_ANNOUNCE, "drop", max_count=1),
        ChaosRule(chaos.SITE_INTEGRITY_CORRUPT, "corrupt", match=a.handler._peer_str),
        ChaosRule(chaos.SITE_MIGRATE_PUSH, "refuse", max_count=1),
    ])
    run(b._announce(ServerState.ONLINE))
    assert [e["site"] for e in plane.fired()] == [chaos.SITE_ANNOUNCE]
    assert run(b.handler.rpc_probe({"seed": 5, "tokens": 4}, None))["fp"] == honest  # not b
    assert run(a.handler.rpc_probe({"seed": 5, "tokens": 4}, None))["fp"] != honest
    snap = {"k": torch.zeros(4, 1, 2, 2, 8), "v": torch.zeros(4, 1, 2, 2, 8), "start": 0, "end": 4,
            "position": 2, "batch_size": 1, "max_length": 16}
    failures = a.handler.migration_stats["push_failures"]
    ok = run(a.handler.migrate_parked_to("s1", snap, b.dht.peer_id.to_string(), b.contact_addr.to_string()))
    assert not ok and a.handler.migration_stats["push_failures"] == failures + 1
    assert [e["site"] for e in plane.fired()] == [
        chaos.SITE_ANNOUNCE, chaos.SITE_INTEGRITY_CORRUPT, chaos.SITE_MIGRATE_PUSH,
    ]
