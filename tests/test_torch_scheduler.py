"""The port's session scheduler, host-memory swap and fair-share admission
(petals_tpu_torch/server/scheduler.py, memory_cache.HostSwapPool, the
batcher's preemption paths and backend.swap_out_pages / swap_in_pages) held
to petals_tpu's, case by case with tests/test_scheduler.py:

- the policy units fed the same inputs on both packages' classes: the same
  victims under each policy, the same admissions, the same HostSwapPool
  stats and ``summary()`` dicts;
- the swap copies against petals_tpu's ``_swap_out_pages_fn`` /
  ``_swap_in_pages_fn`` on the same pool contents (bf16, int8 and nf4a
  pools, identity and relocated pages), bit-equal;
- a port server and a petals_tpu server (tiny-llama, f32) driven alike: the
  batcher's round trip that relocates a lane's pages, preemption on an
  exhausted pool with priority admission, the AllocationFailed text, the
  priority hint of the open message, and the admission order of two peers
  at equal priority (petals_tpu admits the peer holding less; the port
  admitted FIFO before it had the scheduler);
- four sessions on a pool of half their peak pages with the swap tier on:
  both servers reply alike (2e-5), with no AllocationFailed, the same
  step_meta keys, and on each ``swap_outs >= 1`` and ``swap_ins ==
  swap_outs``. The steps are paced by barriers (never by sleeps), and the
  sessions end one at a time after a last step each, so that a lane
  preempted after its last step swaps in before it is released. How many
  swaps a run makes depends on timing, so the two servers' counts are not
  compared.

Every test runs under the port's lock-order sanitizer
(``PETALS_TPU_SANITIZE=1`` and its event-loop policy) and fails on any
violation it records."""

import asyncio
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.data_structures import parse_session_priority as jax_parse_priority
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server import batching as jax_batching
from petals_tpu.server.memory_cache import AllocationFailed as JaxAllocationFailed
from petals_tpu.server.memory_cache import HostSwapPool as JaxSwapPool
from petals_tpu.server.scheduler import SessionScheduler as JaxScheduler
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.analysis import sanitizer
from petals_tpu_torch.data_structures import (
    SESSION_PRIORITY_HIGH,
    SESSION_PRIORITY_LOW,
    SESSION_PRIORITY_NORMAL,
    parse_session_priority,
)
from petals_tpu_torch.ops.paged_attention import PagedPool
from petals_tpu_torch.server import batching as port_batching
from petals_tpu_torch.server.memory_cache import AllocationFailed, HostSwapPool
from petals_tpu_torch.server.scheduler import SessionScheduler
from petals_tpu_torch.server.server import Server, default_dht_prefix
from petals_tpu_torch.telemetry.ledger import ResourceLedger
from petals_tpu.telemetry.ledger import ResourceLedger as JaxLedger
from tests.utils import make_tiny_llama

TOL = 2e-5
N_LAYERS = 2


@pytest.fixture(autouse=True)
def port_sanitizer(monkeypatch):
    """The port's sanitizer on the port's locks: a lock-order cycle or an
    await under a thread lock fails the test at teardown."""
    monkeypatch.setenv("PETALS_TPU_SANITIZE", "1")
    old_policy = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(sanitizer.SanitizingEventLoopPolicy())
    san = sanitizer.get_sanitizer()
    san.reset()
    try:
        yield
        assert not san.violations(), "\n\n".join(san.violations())
    finally:
        asyncio.set_event_loop_policy(old_policy)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def _uids(model_path):
    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(N_LAYERS))


async def _start(kind, model_path, **kw):
    """A port ("port") or petals_tpu ("jax") server over the whole tiny
    model in float32, its batcher, and a petals_tpu RpcClient to it. Each
    batcher bills to a ledger of its own, on a clock that never moves, so
    the fair-share ranks see lanes held and nothing else."""
    if kind == "port":
        server = Server(
            model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
            throughput=1.0, ledger=ResourceLedger(clock=lambda: 0.0), **kw,
        )
        await server.start()
        batcher = server.batcher
    else:
        server = JaxServer(model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0, **kw)
        await server.start()
        batcher = server.handler.batcher
        batcher._ledger = JaxLedger(clock=lambda: 0.0)
        batcher._scheduler.usage_fn = batcher._ledger.peer_dominant_share
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    return server, batcher, client


def _batching_kw(kind, **kw):
    """petals_tpu's Server turns the pool on with ``batching``."""
    return dict(kw, batching=True) if kind == "jax" else kw


async def _until(cond, timeout: float = 30.0) -> None:
    """Yield to the loop until ``cond()`` holds (a bounded poll)."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        await asyncio.sleep(0.001)


# ----------------------------------------------------------- policy units


def test_parse_session_priority_matches_petals_tpu():
    for value in (None, "high", "NORMAL", "low", 0, 1, 2, 7, -3):
        assert parse_session_priority(value) == jax_parse_priority(value), value
    assert parse_session_priority(None, default=SESSION_PRIORITY_LOW) == SESSION_PRIORITY_LOW
    for bad in ("urgent", True, 1.5, []):
        with pytest.raises(ValueError):
            parse_session_priority(bad)
        with pytest.raises(ValueError):
            jax_parse_priority(bad)


@pytest.mark.parametrize("policy", ["lru", "largest", "off"])
def test_victim_selection_matches_petals_tpu(policy):
    """The same registrations, touches and candidate sets give the same
    victims: lowest class first, then LRU (or most pages), never a lane
    more important than the requester, never a suspended or suspending
    one; with a usage function, the dominant peer's lane first."""
    pages = {0: 3, 1: 1, 2: 4, 3: 2}
    shares = {"peer-a": 0.25, "peer-b": 0.75}
    scheds = []
    for sched_cls, pool_cls in ((SessionScheduler, HostSwapPool), (JaxScheduler, JaxSwapPool)):
        plain = sched_cls(pool_cls(1 << 20), policy=policy, pages_fn=pages.get)
        fair = sched_cls(pool_cls(1 << 20), policy=policy, pages_fn=pages.get, usage_fn=lambda p: shares.get(p, 0.0))
        for sched in (plain, fair):
            sched.register(0, "peer-a", SESSION_PRIORITY_HIGH)
            sched.register(1, "peer-a", SESSION_PRIORITY_LOW)
            sched.register(2, "peer-b", SESSION_PRIORITY_LOW)
            sched.register(3, "peer-b", SESSION_PRIORITY_NORMAL)
            sched.touch(2)
        scheds.append((plain, fair))
    queries = [
        ([0, 1, 2, 3], None), ([0, 2, 3], None), ([0, 3], None), ([0], SESSION_PRIORITY_NORMAL),
        ([0, 3], SESSION_PRIORITY_NORMAL), ([1, 2], SESSION_PRIORITY_LOW), ([1, 2, 3], SESSION_PRIORITY_HIGH),
    ]
    (port_plain, port_fair), (jax_plain, jax_fair) = scheds
    for cands, max_priority in queries:
        for port_s, jax_s in ((port_plain, jax_plain), (port_fair, jax_fair)):
            got = port_s.pick_victim(cands, max_priority=max_priority)
            assert got == jax_s.pick_victim(cands, max_priority=max_priority), (cands, max_priority)
    for port_s, jax_s in ((port_plain, jax_plain), (port_fair, jax_fair)):
        port_s.lanes[1].swap, jax_s.lanes[1].swap = object(), object()
        port_s.lanes[2].suspending = jax_s.lanes[2].suspending = True
        assert port_s.pick_victim([1, 2, 3]) == jax_s.pick_victim([1, 2, 3])
    if policy == "off":
        assert port_plain.pick_victim([0, 1, 2, 3]) is None
    for sched_cls, pool_cls in ((SessionScheduler, HostSwapPool), (JaxScheduler, JaxSwapPool)):
        with pytest.raises(ValueError, match="preemption_policy"):
            sched_cls(pool_cls(0), policy="random")


def test_fair_share_admission_matches_petals_tpu():
    """pick_waiter: priority, then the dominant share (with a usage
    function), then lanes held, then FIFO; dead waiters are skipped."""

    async def main():
        loop = asyncio.get_running_loop()
        picks = {}
        for name, sched_cls, pool_cls, waiter_cls in (
            ("port", SessionScheduler, HostSwapPool, port_batching._LaneWaiter),
            ("jax", JaxScheduler, JaxSwapPool, jax_batching._LaneWaiter),
        ):
            def waiter(priority, peer, seq):
                return waiter_cls(fut=loop.create_future(), priority=priority, peer_id=peer, seq=seq)

            order = []
            for usage_fn in (None, {"greedy": 0.9, "light": 0.05}.get):
                sched = sched_cls(pool_cls(0), usage_fn=usage_fn and (lambda p, f=usage_fn: f(p) or 0.0))
                sched.register(0, "greedy", SESSION_PRIORITY_NORMAL)
                sched.register(1, "greedy", SESSION_PRIORITY_NORMAL)
                sched.register(2, "light", SESSION_PRIORITY_NORMAL)
                pending = [
                    waiter(SESSION_PRIORITY_NORMAL, "greedy", 0), waiter(SESSION_PRIORITY_NORMAL, "modest", 1),
                    waiter(SESSION_PRIORITY_LOW, "modest", 2), waiter(SESSION_PRIORITY_HIGH, "greedy", 3),
                    waiter(SESSION_PRIORITY_NORMAL, "light", 4), waiter(SESSION_PRIORITY_NORMAL, "modest", 5),
                ]
                pending[5].fut.set_result(None)  # a caller that already left
                while True:
                    w = sched.pick_waiter(pending)
                    if w is None:
                        break
                    order.append((w.peer_id, w.seq))
                    w.fut.set_result(None)
                    pending.remove(w)
            picks[name] = order
        assert picks["port"] == picks["jax"]
        assert picks["port"][0] == ("greedy", 3)  # priority beats fair share and arrival

    asyncio.run(main())


def test_host_swap_pool_matches_petals_tpu():
    ops = [("r", 60, "session"), ("r", 50, "session"), ("r", 30, "cache"), ("r", 20, "cache"), ("f", 60, "session"),
           ("r", 40, "session"), ("f", 30, "cache"), ("r", 100, "session")]
    pools = [HostSwapPool(100), JaxSwapPool(100)]
    for op, n, kind in ops:
        results = [p.try_reserve(n, kind=kind) if op == "r" else p.free(n, kind=kind) for p in pools]
        assert results[0] == results[1], (op, n, kind)
        assert (pools[0].bytes_in_use, pools[0].cache_bytes_in_use, pools[0].bytes_left) == (
            pools[1].bytes_in_use, pools[1].cache_bytes_in_use, pools[1].bytes_left)
        assert pools[0].stats == pools[1].stats
    assert not HostSwapPool(0).try_reserve(1)
    # the scheduler's summary over it, with a suspended lane
    port_s, jax_s = SessionScheduler(pools[0]), JaxScheduler(pools[1])
    for s in (port_s, jax_s):
        s.register(0, "p", SESSION_PRIORITY_NORMAL)
        s.stats["preemptions"] += 1
    assert port_s.summary() == jax_s.summary()


# ------------------------------------------------- swap copies (the backend)


def _pools(kind, rng, n_blocks=2, n_pages=12, ps=8, hkv=2, d=8):
    """(port pool pair, petals_tpu pool pair) with the same contents: bf16
    pages, or int8 / nf4a codes with float32 scales."""
    if kind == "bf16":
        pairs = []
        for _ in range(2):
            a = rng.standard_normal((n_blocks, n_pages, ps, hkv, d)).astype(ml_dtypes.bfloat16)
            pairs.append((torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16), jnp.asarray(a.copy())))
        return (pairs[0][0], pairs[1][0]), (pairs[0][1], pairs[1][1])
    from petals_tpu.ops.paged_attention import PagedPool as JaxPagedPool

    port, ref = [], []
    for _ in range(2):
        if kind == "int8":
            codes = rng.integers(-127, 128, (n_blocks, n_pages, ps, hkv, d)).astype(np.int8)
        else:
            codes = rng.integers(0, 256, (n_blocks, n_pages, ps, hkv, d // 2)).astype(np.uint8)
        scales = rng.random((n_blocks, n_pages, ps, hkv)).astype(np.float32)
        port.append(PagedPool(torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())))
        ref.append(JaxPagedPool(jnp.asarray(codes.copy()), jnp.asarray(scales.copy())))
    return tuple(port), tuple(ref)


def _np(x) -> np.ndarray:
    """A leaf (torch or JAX) as numpy, bfloat16 through an int16 view."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _leaves(pool):
    return [_np(x) for x in (pool if isinstance(pool, tuple) else (pool,))]


@pytest.fixture(scope="module")
def backends(model_path):
    import jax

    from petals_tpu.server.backend import TransformerBackend as JaxBackend
    from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
    from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
    from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
    from petals_tpu_torch.server.backend import TransformerBackend
    from petals_tpu_torch.server.from_pretrained import get_block_config
    from petals_tpu_torch.utils.convert import stacked_from_numpy

    jfamily, jcfg = jax_block_config(model_path)
    per_block = [jax_load_block(model_path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(N_LAYERS)]
    jax_backend = JaxBackend(
        jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block), first_block=0,
        n_blocks=N_LAYERS, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
    )
    family, cfg = get_block_config(model_path)
    backend = TransformerBackend(
        family, cfg, stacked_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in per_block], "cpu",
                                        torch.float32),
        first_block=0, n_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
    )
    return backend, jax_backend


@pytest.mark.parametrize("kind", ["bf16", "int8", "nf4a"])
def test_swap_copies_match_petals_tpu(backends, kind):
    """swap_out_pages copies exactly the pages named (codes and scales as
    stored), and swap_in_pages writes them onto other page ids in place,
    dropping negative entries: bit-equal to petals_tpu's two functions on
    the same contents, onto the identity layout and a relocated one."""
    backend, jax_backend = backends
    rng = np.random.default_rng(3)
    for src, dst in (([2, 3, 4], [2, 3, 4]), ([7, 1, 10], [0, 11, 5]), ([6, 9], [-1, 3])):
        (k_port, v_port), (k_ref, v_ref) = _pools(kind, rng)
        src_a, dst_a = np.asarray(src, np.int32), np.asarray(dst, np.int32)
        kh, vh = backend.swap_out_pages(k_port, v_port, src_a)
        jk, jv = jax_backend._swap_out_pages_fn(k_ref, v_ref, src_a)
        for got, want in ((kh, jk), (vh, jv)):
            assert isinstance(got, tuple) == isinstance(want, tuple)  # a PagedPool on both, or a tensor
            for g, w in zip(_leaves(got), _leaves(want)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        # into zeroed pools: the written pages read back, the rest stay zero
        zero_port = tuple(type(p)(*(torch.zeros_like(t) for t in p)) if isinstance(p, PagedPool)
                          else torch.zeros_like(p) for p in (k_port, v_port))
        addresses = [t.data_ptr() for p in zero_port for t in (p if isinstance(p, PagedPool) else (p,))]
        backend.swap_in_pages(*zero_port, kh, vh, dst_a)
        import jax

        zero_ref = tuple(jax.tree_util.tree_map(jnp.zeros_like, p) for p in (k_ref, v_ref))
        jk2, jv2 = jax_backend._swap_in_pages_fn(*zero_ref, jk, jv, dst_a)
        for got, want in zip(zero_port, (jk2, jv2)):
            for g, w in zip(_leaves(got), _leaves(want)):
                np.testing.assert_array_equal(g, w)
        # in place: the pools the step programs address never move
        assert addresses == [t.data_ptr() for p in zero_port for t in (p if isinstance(p, PagedPool) else (p,))]


# --------------------------------------------- the batcher, on both servers


def test_batcher_swap_roundtrip_relocates_pages(model_path):
    """Swap lane a out, let lane b take its pages, read a again: both
    batchers swap it back in onto other pages (preempting b for room), the
    content bit-equal, with the same pages, tables and scheduler summary
    at every step."""

    async def scenario(kind):
        server, batcher, client = await _start(kind, model_path, **_batching_kw(
            kind, batch_lanes=2, batch_max_length=32, page_size=8, n_pages=4, swap_host_bytes=1 << 22,
            prefix_cache_bytes=0))
        trail = []
        try:
            sched = batcher._scheduler
            n_blocks = batcher.backend.n_blocks
            a = await batcher.acquire_lane(timeout=5)
            await batcher.prepare_write(a, 0, 16)
            old_pages = [int(p) for p in batcher._tables[a] if p >= 0]
            # stamp recognizable content through a check-in, as a session would
            def stamp(kv_lane):
                k, v = kv_lane
                if kind == "port":
                    k[:, :, :16] = torch.arange(16, dtype=k.dtype)[None, None, :, None, None] + 1.0
                    v[:, :, :16] = -k[:, :, :16]
                    return None, (k, v)
                import jax.numpy as jnp2

                rows = jnp2.arange(16, dtype=k.dtype)[None, None, :, None, None] + 1.0
                k = k.at[:, :, :16].set(jnp2.broadcast_to(rows, k[:, :, :16].shape))
                v = v.at[:, :, :16].set(-k[:, :, :16])
                return None, (k, v)

            if kind == "port":
                await batcher.run_exclusive(a, stamp)
            else:
                await batcher.run_exclusive(a, lambda kv, _temp: stamp(kv))
            before = await batcher.snapshot_lane(a, 16, 0, n_blocks)
            free_before = batcher._pages.n_free
            assert await batcher._swap_out_lane(a)
            assert sched.lanes[a].suspended and batcher._pages.n_free == free_before + 2
            assert np.all(batcher._tables[a] == -1) and not batcher._lane_idle(a)
            trail.append((batcher._tables.copy(), sched.summary()))
            b = await batcher.acquire_lane(timeout=5)
            await batcher.prepare_write(b, 0, 24)
            b_pages = {int(p) for p in batcher._tables[b] if p >= 0}
            assert set(old_pages) & b_pages, "freed pages were not reused"
            b_before = await batcher.snapshot_lane(b, 24, 0, n_blocks)
            after = await batcher.snapshot_lane(a, 16, 0, n_blocks)  # the transparent swap-in
            new_pages = [int(p) for p in batcher._tables[a] if p >= 0]
            assert len(new_pages) == 2 and set(new_pages) != set(old_pages)
            assert not sched.lanes[a].suspended and sched.lanes[b].suspended
            trail.append((batcher._tables.copy(), sched.summary()))
            b_after = await batcher.snapshot_lane(b, 24, 0, n_blocks)
            assert not sched.lanes[b].suspended and sched.lanes[a].suspended
            trail.append((batcher._tables.copy(), sched.summary()))
            for got, want in ((after, before), (b_after, b_before)):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
            batcher.release_lane(a)
            batcher.release_lane(b)
            assert batcher.swap_pool.bytes_in_use == 0 and batcher._pages.n_free == batcher.n_pages
            trail.append((batcher._tables.copy(), sched.summary()))
            return trail, np.asarray(after[0])
        finally:
            await client.close()
            await server.shutdown()

    port_trail, port_rows = asyncio.run(scenario("port"))
    jax_trail, jax_rows = asyncio.run(scenario("jax"))
    np.testing.assert_array_equal(port_rows, jax_rows)
    for (pt, ps), (jt, js) in zip(port_trail, jax_trail):
        np.testing.assert_array_equal(pt, jt)
        for key in ("swap_oldest_s",):
            ps.pop(key), js.pop(key)
        assert ps == js


def test_preemption_on_exhaustion_and_priority_admission(model_path):
    """prepare_write on an exhausted pool preempts an idle victim instead of
    waiting; parked callers are admitted HIGH before LOW, on both."""

    async def scenario(kind):
        server, batcher, client = await _start(kind, model_path, **_batching_kw(
            kind, batch_lanes=2, batch_max_length=32, page_size=8, n_pages=5, swap_host_bytes=1 << 22,
            prefix_cache_bytes=0))
        try:
            a = await batcher.acquire_lane(timeout=5, peer_id="victim")
            b = await batcher.acquire_lane(timeout=5, peer_id="requester")
            await batcher.prepare_write(a, 0, 32)
            assert batcher._pages.n_free == 0
            await batcher.prepare_write(b, 8, 9, timeout=5)
            assert batcher._scheduler.lanes[a].suspended
            low = asyncio.create_task(batcher.acquire_lane(timeout=10, priority=SESSION_PRIORITY_LOW))
            await _until(lambda: len(batcher._lane_waiters) == 1)
            high = asyncio.create_task(batcher.acquire_lane(timeout=10, priority=SESSION_PRIORITY_HIGH))
            await _until(lambda: len(batcher._lane_waiters) == 2)
            batcher.release_lane(b)
            lane_high = await asyncio.wait_for(high, timeout=5)
            assert not low.done()
            summary = dict(batcher._scheduler.summary())
            batcher.release_lane(lane_high)
            lane_low = await asyncio.wait_for(low, timeout=5)
            batcher.release_lane(lane_low)
            batcher.release_lane(a)
            assert batcher.swap_pool.bytes_in_use == 0
            summary.pop("swap_oldest_s")
            return summary, batcher._scheduler.lanes == {}
        finally:
            await client.close()
            await server.shutdown()

    port = asyncio.run(scenario("port"))
    ref = asyncio.run(scenario("jax"))
    assert port == ref
    assert port[0]["preemptions"] == 1 and port[0]["suspended"] == 1


def test_admission_order_matches_petals_tpu(model_path):
    """Two peers queue at equal priority for the one lane: the heavy peer
    first, the light peer second. petals_tpu admits the light peer (it holds
    fewer lanes); so does the port now. Both leave the same summary()."""

    async def scenario(kind):
        server, batcher, client = await _start(kind, model_path, **_batching_kw(
            kind, batch_lanes=2, batch_max_length=32, page_size=8, prefix_cache_bytes=0))
        try:
            held = [await batcher.acquire_lane(timeout=5, peer_id="heavy") for _ in range(2)]
            order = []

            async def wait(peer):
                lane = await batcher.acquire_lane(timeout=10, peer_id=peer)
                order.append(peer)
                return lane

            tasks = []
            for peer in ("heavy", "light"):
                tasks.append(asyncio.create_task(wait(peer)))
                await _until(lambda: len(batcher._lane_waiters) == len(tasks))
            batcher.release_lane(held[0])
            await _until(lambda: bool(order))
            batcher.release_lane(held[1])
            lanes = await asyncio.gather(*tasks)
            summary = batcher._scheduler.summary()
            for lane in lanes:
                batcher.release_lane(lane)
            summary.pop("swap_oldest_s")
            return order, summary
        finally:
            await client.close()
            await server.shutdown()

    port, ref = asyncio.run(scenario("port")), asyncio.run(scenario("jax"))
    assert ref[0] == ["light", "heavy"]
    assert port == ref


def test_allocation_failed_text_matches_petals_tpu(model_path):
    """With the swap tier off an exhausted pool still fails: the message
    names lanes, pages and each lane's holdings, in petals_tpu's words, and
    ptu.info's pool dict carries the scheduler's summary."""

    async def scenario(kind):
        server, batcher, client = await _start(kind, model_path, **_batching_kw(
            kind, batch_lanes=2, batch_max_length=32, page_size=8, n_pages=5, prefix_cache_bytes=0))
        try:
            a = await batcher.acquire_lane(timeout=5)
            await batcher.prepare_write(a, 0, 32)
            b = await batcher.acquire_lane(timeout=5)
            with pytest.raises((AllocationFailed, JaxAllocationFailed)) as exc:
                await batcher.prepare_write(b, 8, 9, timeout=0.2)
            with pytest.raises((AllocationFailed, JaxAllocationFailed)) as exc_lane:
                await batcher.acquire_lane(timeout=0.1)
            info = await client.call("ptu.info", {}, timeout=30)
            batcher.release_lane(a)
            batcher.release_lane(b)
            pool = {k: info["pool"][k] for k in ("lanes", "busy_lanes", "n_pages", "pages_free", "policy",
                                                   "suspended", "swap_bytes_total", "preemptions")}
            return str(exc.value), str(exc_lane.value), pool, sorted(info["pool"])
        finally:
            await client.close()
            await server.shutdown()

    port, ref = asyncio.run(scenario("port")), asyncio.run(scenario("jax"))
    assert port[0] == ref[0] and "lane 0: 4" in port[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2] == {"lanes": 2, "busy_lanes": 2, "n_pages": 5, "pages_free": 0, "policy": "lru",
                                 "suspended": 0, "swap_bytes_total": 0, "preemptions": 0}
    assert port[3] == ref[3]  # the same keys in ServerInfo.pool


def test_session_priority_hint_via_open_message(model_path):
    """The open message's "priority" lands in the scheduler slot; without
    it a session is normal. The open message's peer_hint bills the lane."""

    async def main():
        server, batcher, client = await _start("port", model_path, batch_lanes=4, batch_max_length=32, page_size=8,
                                               prefix_cache_bytes=0)
        try:
            uids = _uids(model_path)
            s1 = await client.open_stream("ptu.inference")
            await s1.send({"uids": uids, "max_length": 16, "batch_size": 1, "priority": "high", "peer_hint": "p-1"})
            await s1.recv(timeout=60)
            s2 = await client.open_stream("ptu.inference")
            await s2.send({"uids": uids, "max_length": 16, "batch_size": 1})
            await s2.recv(timeout=60)
            slots = sorted(batcher._scheduler.lanes.values(), key=lambda s: s.priority)
            assert [s.priority for s in slots] == [SESSION_PRIORITY_HIGH, SESSION_PRIORITY_NORMAL]
            assert [s.peer_id for s in slots] == ["p-1", None]
            await s1.end()
            await s2.end()
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(main())


# --------------------------------------------------- e2e oversubscription


def _sessions(hsz):
    rng = np.random.RandomState(17)
    out = []
    for i in range(4):
        prefill = rng.randn(1, 3 + 5 * i, hsz).astype(np.float32) * 0.1
        steps = [rng.randn(1, 1, hsz).astype(np.float32) * 0.1 for _ in range(7)]
        out.append((prefill, steps))
    return out


async def _oversubscribed_run(kind, model_path):
    """Four sessions on 4 pages of 16 tokens (their peak is 6): prefills at
    once, six decode steps in barrier rounds (a lane waiting at a barrier
    holds its pages, idle), then a seventh step and the session's end one
    session at a time, each after the previous lane is released. Returns
    (every reply, the step_meta keys of decode replies, the scheduler's
    stats, the usage deltas' token sums)."""
    server, batcher, client = await _start(kind, model_path, **_batching_kw(
        kind, batch_lanes=4, batch_max_length=64, page_size=16, n_pages=4, swap_host_bytes=1 << 26))
    try:
        uids = _uids(model_path)
        sessions = _sessions(server.cfg.hidden_size)
        n_rounds = 6
        arrived = [0] * (n_rounds + 1)
        gates = [asyncio.Event() for _ in range(n_rounds + 1)]
        turn = [asyncio.Event() for _ in range(len(sessions) + 1)]
        turn[0].set()
        meta_keys, tokens = set(), [0] * len(sessions)

        async def barrier(k):
            arrived[k] += 1
            if arrived[k] == len(sessions):
                gates[k].set()
            await gates[k].wait()

        async def step(stream, h, s):
            await stream.send({"tensors": {"hidden": serialize_array(h)}})
            reply = await stream.recv(timeout=120)
            meta = reply["step_meta"]
            if h.shape[1] == 1:
                meta_keys.update(meta)
            usage = meta.get("usage", {})
            tokens[s] += usage.get("prefill_tokens", 0) + usage.get("decode_tokens", 0)
            return deserialize_array(reply["tensors"]["hidden"])

        async def drive(s, prefill, steps):
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": 40, "batch_size": 1, "peer_hint": f"peer-{s}"})
            await stream.recv(timeout=60)
            await barrier(0)
            outs = [await step(stream, prefill, s)]
            for k in range(n_rounds):
                await barrier(k + 1)
                outs.append(await step(stream, steps[k], s))
            await turn[s].wait()
            outs.append(await step(stream, steps[n_rounds], s))
            n_busy = batcher.occupancy_hint()["busy_lanes"]
            await stream.end()
            await _until(lambda: batcher.occupancy_hint()["busy_lanes"] < n_busy)  # the server released it
            turn[s + 1].set()
            return outs

        results = await asyncio.gather(*(drive(s, p, st) for s, (p, st) in enumerate(sessions)))
        assert batcher._pages.n_free == batcher.n_pages and batcher.swap_pool.bytes_in_use == 0
        return results, meta_keys, dict(batcher._scheduler.stats), tokens, dict(batcher.stats)
    finally:
        await client.close()
        await server.shutdown()


def test_e2e_oversubscription_preemption(model_path):
    port = asyncio.run(_oversubscribed_run("port", model_path))
    ref = asyncio.run(_oversubscribed_run("jax", model_path))
    for name, (results, meta_keys, stats, tokens, _) in (("port", port), ("petals_tpu", ref)):
        assert stats["swap_outs"] >= 1, (name, stats)
        assert stats["swap_ins"] == stats["swap_outs"], (name, stats)
    for s, (got, want) in enumerate(zip(port[0], ref[0])):
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"session {s} reply {i}")
    # the same step_meta keys on a pooled decode reply (fingerprints, "fp",
    # are not ported)
    assert port[1] == ref[1] - {"fp"}
    assert {"busy_lanes", "lane_waiters", "usage"} <= port[1]
    # every token billed to its session, on both: the prefill and the seven steps
    assert port[3] == ref[3] == [3 + 5 * s + 7 for s in range(4)]


def test_prefix_hit_on_a_preempted_lane_seeds_after_a_swap_in(model_path):
    """A lane preempted between its admission and its first step (idle, one
    page) does not adopt the cache's pinned pages, which its swap-in would
    write over: the hit seeds through the exclusive path, which swaps the
    lane in first. The reply equals the first session's, no pinned page
    leaks, and the pool drains."""

    async def main():
        server, batcher, client = await _start("port", model_path, batch_lanes=2, batch_max_length=256,
                                               page_size=16, swap_host_bytes=1 << 24)
        try:
            uids = _uids(model_path)
            prompt = np.random.RandomState(21).randn(1, 130, 64).astype(np.float32) * 0.1
            pc = server.handler.prefix_cache
            replies = []
            for preempt in (False, True):
                stream = await client.open_stream("ptu.inference")
                await stream.send({"uids": uids, "max_length": 200, "batch_size": 1, "peer_hint": "p"})
                await stream.recv(timeout=60)
                if preempt:
                    lane = next(iter(batcher._scheduler.lanes))
                    assert await batcher._swap_out_lane(lane)
                    assert not batcher.lane_resident(lane)
                await stream.send({"tensors": {"hidden": serialize_array(prompt)}})
                replies.append(deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"]))
                await stream.send({"tensors": {"hidden": serialize_array(prompt[:, :1])}})
                await stream.recv(timeout=60)
                await stream.end()
                await _until(lambda: batcher.occupancy_hint()["busy_lanes"] == 0)
            assert pc.stats["hits"] == 1 and pc.stats.get("page_hits", 0) == 0
            np.testing.assert_allclose(replies[1], replies[0], atol=TOL, rtol=0)
            stats = batcher._scheduler.stats
            assert stats["swap_outs"] == stats["swap_ins"] == 1
            pinned = sum(len(e.get("pages", ())) for e in pc._store.values())
            assert batcher._pages.n_free == batcher.n_pages - pinned and batcher.swap_pool.bytes_in_use == 0
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(main())
