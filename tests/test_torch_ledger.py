"""The port's resource ledger (petals_tpu_torch/telemetry/ledger.py) held to
petals_tpu's, case by case with tests/test_ledger.py's unit cases: each
scenario drives a port ledger and a petals_tpu ledger alike, each on a fake
clock of its own advanced in step, and every answer, ``snapshot()`` and
``digest()`` must be equal (the port's ``PageAllocator.fractional_shares``
and ``SessionScheduler`` beside them). Then the bills a port server's
pooled replies carry (step_meta ``usage``) beside a petals_tpu server's on
the same session with one forced swap out and in: the token counts and the
swap bytes are equal; the time meters (page-, lane- and compute-seconds)
are measured on each server's own clock, so each is held within the
session's wall time instead.

Left out with the parts of the telemetry package that are not ported
(ROADMAP A11): the /ledger endpoint, the metrics exposition, the health
monitor and run_health."""

import asyncio
import json
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petals_tpu.server.batching as jax_batching
import petals_tpu.server.memory_cache as jax_mc
import petals_tpu.server.scheduler as jax_sched
import petals_tpu.telemetry.ledger as jax_ledger
import petals_tpu_torch.server.batching as port_batching
import petals_tpu_torch.server.memory_cache as port_mc
import petals_tpu_torch.server.scheduler as port_sched
import petals_tpu_torch.telemetry.ledger as port_ledger
from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import serialize_array
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.server.server import Server, default_dht_prefix
from tests.utils import make_tiny_llama

PORT = SimpleNamespace(led=port_ledger, mc=port_mc, sched=port_sched, waiter=port_batching._LaneWaiter)
JAX = SimpleNamespace(led=jax_ledger, mc=jax_mc, sched=jax_sched, waiter=jax_batching._LaneWaiter)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_ledger(pkg, **kw):
    clock = FakeClock()
    kw.setdefault("window_s", 10.0)
    kw.setdefault("noisy_min_interval_s", 0.0)
    kw.setdefault("noisy_cooldown_s", 0.0)
    return pkg.led.ResourceLedger(clock=clock, **kw), clock


def both(scenario):
    """Run ``scenario(pkg)`` on the port and on petals_tpu; the answers must
    be equal. Returns the port's."""
    got, want = scenario(PORT), scenario(JAX)
    assert got == want
    return got


def test_constants_match_petals_tpu():
    assert port_ledger.USAGE_FIELDS == jax_ledger.USAGE_FIELDS
    assert port_ledger.DRF_RESOURCES == jax_ledger.DRF_RESOURCES
    assert (port_ledger.ANON_PEER, port_ledger.OVERFLOW_PEER) == (jax_ledger.ANON_PEER, jax_ledger.OVERFLOW_PEER)
    assert port_ledger.ResourceLedger().max_peers == jax_ledger.ResourceLedger().max_peers
    for usage in ({}, {"spec_proposed": 4, "spec_accepted": 3, "compute_seconds": 2.0, "decode_tokens": 5}):
        assert port_ledger.derive_efficiency(usage) == jax_ledger.derive_efficiency(usage)


def test_fractional_cow_conservation_under_refcount_churn():
    """Adopt, fork, a prefix pin and a dead lane's release move refcounts;
    the lanes' page-seconds (1/refcount a page, fractional_shares) plus the
    unattributed rest integrate to the pool's occupancy."""

    def scenario(pkg):
        led, clock = make_ledger(pkg)
        alloc = pkg.mc.PageAllocator(8)
        tables = np.full((2, 4), -1, np.int64)

        def sync(keys_by_row):
            rows = list(keys_by_row)
            shares = alloc.fractional_shares(tables[rows])
            led.set_rates({keys_by_row[r]: float(s) for r, s in zip(rows, shares)}, float(alloc.n_pages - alloc.n_free))

        a, b = led.open_session("peer-a"), led.open_session("peer-b")
        p0, p1 = alloc.try_alloc(), alloc.try_alloc()
        tables[0, 0], tables[0, 1] = p0, p1
        sync({0: a, 1: b})
        clock.advance(1.0)
        alloc.incref(p0)
        tables[1, 0] = p0
        sync({0: a, 1: b})
        clock.advance(1.0)
        p2 = alloc.try_alloc()
        tables[1, 1] = p2
        sync({0: a, 1: b})
        clock.advance(1.0)
        alloc.incref(p1)
        sync({0: a, 1: b})
        clock.advance(1.0)
        alloc.decref(p0)
        alloc.decref(p1)
        tables[0, :] = -1
        totals_a = led.close_session(a)
        sync({1: b})
        clock.advance(1.0)
        alloc.decref(p1)
        sync({1: b})
        clock.advance(1.0)
        totals_b = led.close_session(b)
        snap = led.snapshot()
        return totals_a, totals_b, snap, led.digest(), led.attributed_page_seconds(), alloc.fragmentation_info()

    totals_a, totals_b, snap, _, attributed, _ = both(scenario)
    assert totals_a["page_seconds"] == pytest.approx(2 + 1.5 + 1.5 + 1.0)
    assert totals_b["page_seconds"] == pytest.approx(0.5 + 1.5 + 1.5 + 2 + 2)
    assert snap["unattributed_page_seconds"] == pytest.approx(0.5 + 1.0)
    assert attributed + snap["unattributed_page_seconds"] == pytest.approx(snap["pool_page_seconds"])


def test_lazy_reads_do_not_disturb_rates():
    def scenario(pkg):
        led, clock = make_ledger(pkg)
        a = led.open_session("p")
        led.set_rates({a: 2.0}, 2.0)
        for _ in range(5):
            clock.advance(0.2)
            led.snapshot()
            led.session_usage(a)
        clock.advance(1.0)
        return led.close_session(a), led.snapshot()

    totals, _ = both(scenario)
    assert totals["page_seconds"] == pytest.approx(4.0)


def test_ledger_exact_under_concurrent_writers():
    """Eight threads on the additive meters against concurrent settles and
    reads: the integer meters come out exact on both."""

    def scenario(pkg):
        led, _ = make_ledger(pkg)
        keys = [led.open_session(f"peer-{i}") for i in range(8)]
        n_iters, stop = 300, threading.Event()

        def writer(key):
            for _ in range(n_iters):
                led.note_compute([key], 1e-4)
                led.note_tokens(key, prefill=2, decode=1)
                led.note_swap(key, out_bytes=3, in_bytes=2)
                led.note_migrated(key, 5)

        def reader():
            while not stop.is_set():
                led.snapshot(k=8)
                led.usage_delta(keys[0])

        threads = [threading.Thread(target=writer, args=(k,)) for k in keys]
        spectators = [threading.Thread(target=reader) for _ in range(2)]
        for t in threads + spectators:
            t.start()
        for t in threads:
            t.join()
        stop.set()
        for t in spectators:
            t.join()
        totals = led.peer_totals()
        for u in totals.values():
            assert u["compute_seconds"] == pytest.approx(n_iters * 1e-4, rel=1e-9)
        return {p: {f: u[f] for f in ("decode_tokens", "prefill_tokens", "swap_out_bytes", "swap_in_bytes",
                                      "migrated_bytes")} for p, u in totals.items()}

    totals = both(scenario)
    assert totals["peer-3"] == {"decode_tokens": 300, "prefill_tokens": 600, "swap_out_bytes": 900,
                                "swap_in_bytes": 600, "migrated_bytes": 1500}


def test_normalize_peer_and_overflow_discipline():
    def scenario(pkg):
        norm = [pkg.led.normalize_peer(p) for p in (None, "", "x" * 200, "abc")]
        led, _ = make_ledger(pkg, max_peers=2)
        led.open_session("p1")
        led.open_session("p2")
        k3, k4 = led.open_session("p3"), led.open_session("p4")
        led.note_tokens(k3, decode=1)
        led.note_tokens(k4, decode=1)
        led.note_migrated(None, 7, peer_id="p5")
        return norm, led.peer_overflows, led.peer_totals(), led.snapshot(), led.digest()

    norm, overflows, totals, _, _ = both(scenario)
    assert norm[:2] == [port_ledger.ANON_PEER] * 2 and len(norm[2]) == 64
    assert overflows == 2 and totals[port_ledger.OVERFLOW_PEER]["migrated_bytes"] == 7


def test_usage_delta_pops_and_close_folds_rollup():
    def scenario(pkg):
        led, clock = make_ledger(pkg)
        a = led.open_session("peer-a", trace_id="t-1")
        led.set_rates({a: 1.0}, 1.0)
        clock.advance(1.0)
        led.note_tokens(a, decode=3)
        d1, d2 = led.usage_delta(a), led.usage_delta(a)
        clock.advance(0.5)
        d3 = led.usage_delta(a)
        none = led.usage_delta("nope")
        led.close_session(a)
        return d1, d2, d3, none, led.peer_totals(), led.session_usage(a), type(d1["decode_tokens"]).__name__

    d1, d2, d3, none, totals, after, int_name = both(scenario)
    assert d1["decode_tokens"] == 3 and int_name == "int" and d2 == {} and none is None and after is None
    assert d3["page_seconds"] == pytest.approx(0.5) and totals["peer-a"]["decode_tokens"] == 3


def _drive_two_peers(led, clock, greedy, light):
    led.set_rates({greedy: 3.0, light: 1.0}, 4.0)
    clock.advance(2.0)
    led.note_compute([greedy], 0.9)
    led.note_compute([light], 0.1)


def test_noisy_neighbor_detector_and_cooldown():
    def scenario(pkg):
        led, clock = make_ledger(pkg, noisy_share=0.5, noisy_cooldown_s=5.0)
        g, l = led.open_session("greedy"), led.open_session("light")
        _drive_two_peers(led, clock, g, l)
        out = [led.check_noisy([]), led.check_noisy(["greedy"]), led.check_noisy(["light", "other"])]
        clock.advance(1.0)
        out.append(led.check_noisy(["light"]))
        clock.advance(5.0)
        out.append(led.check_noisy(["light"]))
        return out, led.noisy_events, led.snapshot(), led.digest()

    out, events, _, _ = both(scenario)
    assert out[0] is None and out[1] is None and out[3] is None
    assert out[2]["peer"] == out[4]["peer"] == "greedy" and events == 2


def test_noisy_detector_respects_min_interval():
    def scenario(pkg):
        led, clock = make_ledger(pkg, noisy_min_interval_s=1.0, noisy_share=0.5)
        g, l = led.open_session("greedy"), led.open_session("light")
        _drive_two_peers(led, clock, g, l)
        first = led.check_noisy(["light"])
        clock.advance(0.5)
        return first, led.check_noisy(["light"])

    first, second = both(scenario)
    assert first is not None and second is None


def test_dominant_share_ignores_uncontended_resources():
    def scenario(pkg):
        led, clock = make_ledger(pkg)
        a = led.open_session("a")
        led.open_session("b")
        led.note_tokens(a, decode=0)
        clock.advance(1.0)
        s1 = led.peer_dominant_share("a")
        led.note_swap(a, out_bytes=0, in_bytes=0)
        clock.advance(1.0)
        return s1, led.peer_dominant_share("a")

    assert both(scenario) == (0.0, 0.0)


def test_rebase_window_forgets_history():
    def scenario(pkg):
        led, clock = make_ledger(pkg)
        g, l = led.open_session("greedy"), led.open_session("light")
        _drive_two_peers(led, clock, g, l)
        before = led.peer_dominant_share("greedy")
        led.rebase_window()
        led.set_rates({g: 0.0, l: 0.0}, 0.0)
        clock.advance(1.0)
        return before, led.peer_dominant_share("greedy")

    before, after = both(scenario)
    assert before >= 0.5 and after == 0.0


def test_snapshot_digest_shapes():
    def scenario(pkg):
        led, clock = make_ledger(pkg)
        a = led.open_session("peer-a", trace_id="tr")
        led.set_rates({a: 2.0}, 2.0)
        clock.advance(1.0)
        return led.snapshot(k=3), led.digest(k=2)

    snap, dig = both(scenario)
    live = snap["live_sessions"][0]
    assert live["peer"] == "peer-a" and live["trace_id"] == "tr"
    assert all(f in live for f in port_ledger.USAGE_FIELDS)
    assert set(dig) == {"peers", "sessions", "page_s", "compute_s", "cache_byte_s", "noisy", "top"}
    json.dumps(dig)


def test_cache_residency_channel_is_conservation_neutral():
    def scenario(pkg):
        led, clock = make_ledger(pkg)
        a = led.open_session("peer-a")
        led.set_rates({a: 2.0}, 2.0)
        led.set_cache_rates({"peer-a": 1000.0, "peer-b": 3000.0})
        clock.advance(2.0)
        r1 = led.cache_residency()
        led.set_cache_rates({"peer-a": 500.0})
        clock.advance(1.0)
        return (r1, led.cache_residency(), led.pool_page_seconds, led.attributed_page_seconds(),
                led.peer_dominant_share("peer-b"), led.snapshot(k=3), led.digest(k=2))

    r1, r2, pool, attributed, share_b, snap, _ = both(scenario)
    assert r1["peer-b"] == pytest.approx(6000.0) and r2["peer-a"] == pytest.approx(2500.0)
    assert pool == pytest.approx(6.0) == attributed and share_b == 0.0
    assert snap["cache_byte_seconds"] == pytest.approx(8500.0)


def test_cache_rates_respect_peer_cardinality_bound():
    def scenario(pkg):
        led, clock = make_ledger(pkg, max_peers=2)
        led.set_cache_rates({f"peer-{i}": 100.0 for i in range(5)})
        clock.advance(1.0)
        return led.cache_residency()

    resid = both(scenario)
    assert resid[port_ledger.OVERFLOW_PEER] == pytest.approx(300.0)


def test_scheduler_ranks_by_dominant_share():
    """A scheduler wired to a ledger: pick_waiter prefers the lighter peer
    and pick_victim the heavier one, on both; a failing usage function
    ranks 0.0."""

    def scenario(pkg):
        async def main():
            loop = asyncio.get_running_loop()
            led, clock = make_ledger(pkg)
            g, l = led.open_session("greedy"), led.open_session("light")
            _drive_two_peers(led, clock, g, l)
            sched = pkg.sched.SessionScheduler(pkg.mc.HostSwapPool(0), usage_fn=led.peer_dominant_share)
            sched.register(0, "light", 1)
            waiters = [pkg.waiter(fut=loop.create_future(), priority=1, peer_id=p, seq=i)
                       for i, p in enumerate(("greedy", "light"))]
            admitted = sched.pick_waiter(waiters).peer_id
            sched2 = pkg.sched.SessionScheduler(pkg.mc.HostSwapPool(1 << 20), pages_fn={0: 2, 1: 2}.get,
                                                usage_fn=led.peer_dominant_share)
            sched2.register(0, "light", 1)
            sched2.register(1, "greedy", 1)
            sched2.touch(0)
            sched2.touch(1)
            broken = pkg.sched.SessionScheduler(pkg.mc.HostSwapPool(0), usage_fn=lambda p: 1 / 0)
            return admitted, sched2.pick_victim([0, 1]), broken.peer_usage_share("anyone")

        return asyncio.run(main())

    assert both(scenario) == ("light", 1, 0.0)


def test_fair_share_reduces_light_peer_admission_wait():
    """One greedy tenant's four queued sessions against three light ones:
    with the ledger's shares every light session is admitted first; with
    none, FIFO. The same positions on both."""

    def positions(pkg, usage_fn):
        async def main():
            loop = asyncio.get_running_loop()
            sched = pkg.sched.SessionScheduler(pkg.mc.HostSwapPool(0), usage_fn=usage_fn)
            pending = [pkg.waiter(fut=loop.create_future(), priority=1, peer_id=p, seq=i)
                       for i, p in enumerate(["greedy"] * 4 + ["light-1", "light-2", "light-3"])]
            order = []
            while pending:
                w = sched.pick_waiter(pending)
                w.fut.set_result(None)
                pending.remove(w)
                order.append(w.peer_id)
            return [i for i, p in enumerate(order) if p.startswith("light")]

        return asyncio.run(main())

    shares = {"greedy": 0.8}
    fair = both(lambda pkg: positions(pkg, lambda p: shares.get(p, 0.0)))
    fifo = both(lambda pkg: positions(pkg, None))
    assert fair == [0, 1, 2] and fifo == [4, 5, 6]


# ------------------------------------------------- the bills in the replies


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=2)


async def _billed_session(kind, model_path):
    """One pooled session (peer_hint "tenant-a"): a 12-token prefill, two
    decode steps, the lane swapped out by hand, a third step that swaps it
    back in. Returns the usage delta of each reply, the page's wire bytes
    and the session's wall time."""
    kw = dict(batch_lanes=2, batch_max_length=32, page_size=8, n_pages=4, swap_host_bytes=1 << 22,
              prefix_cache_bytes=0)
    if kind == "port":
        server = Server(model_path, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32,
                        throughput=1.0, ledger=port_ledger.ResourceLedger(), **kw)
        await server.start()
        batcher = server.batcher
        page_bytes = batcher.page_nbytes
    else:
        server = JaxServer(model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0, batching=True,
                           **kw)
        await server.start()
        batcher = server.handler.batcher
        batcher._ledger = jax_ledger.ResourceLedger()
        batcher._scheduler.usage_fn = batcher._ledger.peer_dominant_share
        page_bytes = batcher._page_nbytes()
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    try:
        uids = CHAIN_DELIMITER.join(make_uid(default_dht_prefix(model_path), i) for i in range(2))
        rng = np.random.RandomState(5)
        t0 = time.perf_counter()
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": 32, "batch_size": 1, "peer_hint": "tenant-a"})
        await stream.recv(timeout=60)
        lane = next(l for l, s in batcher._scheduler.lanes.items() if s.peer_id == "tenant-a")
        bills, metas = [], []
        for i, n in enumerate((12, 1, 1, 1)):
            if i == 3:
                assert await batcher._swap_out_lane(lane)
            await stream.send({"tensors": {"hidden": serialize_array(rng.randn(1, n, 64).astype(np.float32) * 0.1)}})
            meta = (await stream.recv(timeout=60))["step_meta"]
            metas.append({k: meta[k] for k in ("busy_lanes", "lane_waiters")})
            bills.append(meta["usage"])
        wall = time.perf_counter() - t0
        await stream.end()
        return bills, metas, page_bytes, wall
    finally:
        await client.close()
        await server.shutdown()


def test_reply_bills_match_petals_tpu(model_path):
    """The same session on a port server and a petals_tpu server: the load
    hint and every reply's token counts and swap bytes are equal (2 pages
    out and in); the time meters are positive on both and within the
    session's wall time (lane-seconds), times the lane's 2 pages
    (page-seconds); compute-seconds within it too."""
    port = asyncio.run(_billed_session("port", model_path))
    ref = asyncio.run(_billed_session("jax", model_path))
    assert port[1] == ref[1] == [{"busy_lanes": 1, "lane_waiters": 0}] * 4
    assert port[2] == ref[2]
    counted = ("prefill_tokens", "decode_tokens", "swap_out_bytes", "swap_in_bytes")
    for got, want in zip(port[0], ref[0]):
        assert {k: got.get(k, 0) for k in counted} == {k: want.get(k, 0) for k in counted}
    assert port[0][3]["swap_out_bytes"] == port[0][3]["swap_in_bytes"] == 2 * port[2]
    assert [b.get("prefill_tokens", 0) for b in port[0]] == [12, 0, 0, 0]
    for bills, wall in ((port[0], port[3]), (ref[0], ref[3])):
        lane_s = sum(b.get("lane_seconds", 0.0) for b in bills)
        page_s = sum(b.get("page_seconds", 0.0) for b in bills)
        compute_s = sum(b.get("compute_seconds", 0.0) for b in bills)
        assert 0 < lane_s <= wall and 0 < page_s <= 2 * wall and 0 < compute_s <= wall
