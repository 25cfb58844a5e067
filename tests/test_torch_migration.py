"""Session KV migration with port servers and the port's client
(tests/test_migration.py with one or both sides swapped for the port).

- A repair rebuilds only the failed span's range: the healthy downstream
  session, and its server-side KV, survive untouched.
- A draining server (``Server.drain``) parks its sessions' KV and pushes it
  to a replica (``migrate=True``: the client follows the redirect and adopts
  it there, with no KV bytes over its link and no replay), or serves it by
  ``ptu.session_export`` (``migrate=False``: the client imports it). Both
  with the port's client over port servers, and export/import with
  petals_tpu's client from a petals_tpu server to a port server and back.
- Exports of unknown sessions, malformed imports and steps to a draining
  server get petals_tpu's errors; a stale export is topped up by replaying
  the steps it missed; a faster server joining mid-generation takes the
  session over by live export; shutdown aborts a migration push in flight,
  and the push's deadline covers a delay (injected by holding the push's
  connection back, not through chaos).
- The port's CLI parses ``--drain_seconds`` and ``--phase_tier`` with
  petals_tpu's defaults.

Function-scoped swarms: each drain test drains a server. Greedy streams are
held to HF's (float32 servers). Every wait is bounded."""

import asyncio
import time

import numpy as np
import pytest

from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from petals_tpu_torch.client.inference_session import InferenceSession
from tests.test_torch_client import Route, hf_greedy
from tests.utils import make_tiny_llama

N_LAYERS = 4

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def port_client(path, route, **config):
    return AutoDistributedModelForCausalLM.from_pretrained(
        path, initial_peers=route.initial_peers, device="cpu", min_backoff=0.1, **config,
    )


def jax_client(path, route, **config):
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    return JaxClient.from_pretrained(path, initial_peers=route.initial_peers, min_backoff=0.1, **config)


def same_peer(a, b) -> bool:
    return a.to_string() == b.to_string()


def test_repair_keeps_downstream_sessions(model_path, tmp_path):
    """Killing the front server must not recreate (or replay into) the
    downstream [2, 4) session: its KV survives in place."""
    route = Route(
        model_path,
        [("port", 0, 2, dict(throughput=1000.0)),  # preferred front
         ("port", 0, 2, dict(throughput=1.0)),  # understudy front
         ("port", 2, 2, dict(throughput=1000.0))],  # the only back
        str(tmp_path),
    ).start()
    model = port_client(model_path, route)
    try:
        ids = np.random.RandomState(0).randint(0, 100, (1, 5)).astype(np.int64)
        expected = hf_greedy(model_path, ids, 6)
        with model.remote.inference_session(max_length=16, batch_size=1) as session:
            first = model.generate(ids, max_new_tokens=3, session=session)
            np.testing.assert_array_equal(first, expected[:, :8])
            sessions = session._session._sessions
            front = next(s for s in sessions if s.span.start == 0)
            back = next(s for s in sessions if s.span.start == 2)
            assert same_peer(front.span.peer_id, route.servers[0].dht.peer_id)
            victim = route.servers.pop(0)
            route.loop.run(victim.shutdown())
            final = model.generate(first, max_new_tokens=3, session=session)
            np.testing.assert_array_equal(final, expected)
            after = session._session._sessions
            back_after = next(s for s in after if s.span.start == 2)
            assert back_after is back and not back_after.closed
            front_after = next(s for s in after if s.span.start == 0)
            assert same_peer(front_after.span.peer_id, route.servers[0].dht.peer_id)
    finally:
        model.close()
        route.stop()


def spy_repair_paths(monkeypatch, cls=InferenceSession):
    """Instrument every KV-seeding path a repair can take; returns the logs."""
    adopts, imports, replays = [], [], []
    real_adopt, real_import, real_replay = cls._seed_by_adopt, cls._seed_by_import, cls._replay_step

    async def spy_adopt(self, session, source_session_id, export_pos, replay_steps):
        ok = await real_adopt(self, session, source_session_id, export_pos, replay_steps)
        adopts.append(ok)
        return ok

    async def spy_import(self, session, exported, replay_steps):
        ok = await real_import(self, session, exported, replay_steps)
        imports.append(ok)
        return ok

    async def spy_replay(self, session, chunk, hypo_step, step_id):
        replays.append(step_id)
        return await real_replay(self, session, chunk, hypo_step, step_id)

    monkeypatch.setattr(cls, "_seed_by_adopt", spy_adopt)
    monkeypatch.setattr(cls, "_seed_by_import", spy_import)
    monkeypatch.setattr(cls, "_replay_step", spy_replay)
    return adopts, imports, replays


# (fast server, understudy, client): the port's client over port servers,
# petals_tpu's client from petals_tpu to port and from port to petals_tpu
DRAIN_CASES = {
    "port": ("port", "port", "port"),
    "jax_to_port": ("jax", "port", "jax"),
    "port_to_jax": ("port", "jax", "jax"),
}


def run_drain(path, tmp_path, monkeypatch, case, migrate):
    fast_kind, understudy_kind, client_kind = DRAIN_CASES[case]
    route = Route(
        path, [(fast_kind, 0, N_LAYERS, dict(throughput=1000.0)), (understudy_kind, 0, N_LAYERS, dict(throughput=1.0))],
        str(tmp_path),
    ).start()
    if client_kind == "port":
        logs = spy_repair_paths(monkeypatch)
        model = port_client(path, route)
    else:
        from petals_tpu.client.inference_session import InferenceSession as JaxSession

        logs = spy_repair_paths(monkeypatch, JaxSession)
        model = jax_client(path, route)
    try:
        ids = np.random.RandomState(1).randint(0, 100, (1, 6)).astype(np.int64)
        expected = hf_greedy(path, ids, 6)
        with model.remote.inference_session(max_length=16, batch_size=1) as session:
            first = model.generate(ids, max_new_tokens=3, session=session)
            np.testing.assert_array_equal(first, expected[:, :9])
            fast, understudy = route.servers
            assert same_peer(session._session._sessions[0].span.peer_id, fast.dht.peer_id)
            assert route.loop.run(fast.drain(migrate=migrate)) == 1
            final = model.generate(first, max_new_tokens=3, session=session)
            assert same_peer(session._session._sessions[0].span.peer_id, understudy.dht.peer_id)
        np.testing.assert_array_equal(final, expected)
        return logs
    finally:
        model.close()
        route.stop()


@pytest.mark.parametrize("case", ["port"])
def test_drain_migrates_kv_p2p(model_path, tmp_path, monkeypatch, case):
    """The default drain pushes parked KV server to server; the client
    follows the redirect and adopts the cache in place: no KV bytes over the
    client's link, no history replay."""
    adopts, imports, replays = run_drain(model_path, tmp_path, monkeypatch, case, migrate=True)
    assert adopts == [True], "the repair must adopt the migrated KV at the destination"
    assert imports == [], "no import over the client's link when the server pushed"
    assert replays == [], "no history replay when the whole cache moved"


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_migrates_kv_export_import(model_path, tmp_path, monkeypatch, case):
    """drain(migrate=False): the drained server serves its parked KV over
    the client's link and the client imports it into the replacement,
    without replaying history, between any two kinds of server."""
    adopts, imports, replays = run_drain(model_path, tmp_path, monkeypatch, case, migrate=False)
    assert imports == [True], "the repair must seed the replacement by KV import"
    assert adopts == [], "no adopt without a migration redirect"
    assert replays == [], "no history replay when the whole cache moved"


async def _rpc(server):
    from petals_tpu.rpc.client import RpcClient

    return await RpcClient.connect(server.rpc_server.host, server.rpc_server.port)


def _uids(server):
    return " ".join(f"{server.dht_prefix}.{i}" for i in range(N_LAYERS))


async def _expect_error(stream, match):
    from petals_tpu.rpc.client import RpcError

    with pytest.raises(RpcError, match=match):
        await stream.recv(timeout=60)


def test_export_rejects_unknown_and_bad_imports(model_path, tmp_path):
    """Exports of unknown sessions fail cleanly, and imports with a bad
    shape, a bad position or after a step are refused, with petals_tpu's
    errors."""
    from petals_tpu.rpc.serialization import serialize_array

    route = Route(model_path, [("port", 0, N_LAYERS)], str(tmp_path)).start()
    server = route.servers[0]
    hsz = server.cfg.hidden_size

    async def check():
        client = await _rpc(server)
        try:
            with pytest.raises(Exception, match="(?i)no live or parked"):
                await client.call("ptu.session_export", {"session_id": "nope", "start": 0, "end": N_LAYERS})
            for bad_step, match in (
                ({"kv_import": {"position": 2}, "tensors": {
                    "k": serialize_array(np.zeros((4, 1, 2, 3, 5), np.float32)),
                    "v": serialize_array(np.zeros((4, 1, 2, 3, 5), np.float32))}}, "kv_import k shape"),
                ({"kv_import": {"position": 9}, "tensors": {}}, r"kv_import position 9 outside \(0, 8\]"),
                ({"kv_adopt": {"session_id": "nope", "position": 2}}, "No migrated or parked KV"),
            ):
                stream = await client.open_stream("ptu.inference")
                await stream.send({"uids": _uids(server), "max_length": 8, "batch_size": 1})
                assert (await stream.recv(timeout=60)).get("session_open")
                await stream.send(bad_step)
                await _expect_error(stream, match)
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": _uids(server), "max_length": 8, "batch_size": 1})
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": serialize_array(np.zeros((1, 2, hsz), np.float32))}})
            await stream.recv(timeout=60)
            await stream.send({"kv_import": {"position": 2}, "tensors": {}})
            await _expect_error(stream, "kv_import must be the first step of a session")
        finally:
            await client.close()

    try:
        route.loop.run(check())
    finally:
        route.stop()


def test_draining_refuses_sessions_and_steps(model_path, tmp_path):
    """A draining port server refuses a new session and the next step of a
    live one, with petals_tpu's messages, and refuses migrated sessions; a
    session it parked stays exportable."""
    from petals_tpu.rpc.serialization import serialize_array

    route = Route(model_path, [("port", 0, N_LAYERS)], str(tmp_path)).start()
    server = route.servers[0]
    hidden = serialize_array(np.random.RandomState(3).randn(1, 3, server.cfg.hidden_size).astype(np.float32))

    async def check():
        client = await _rpc(server)
        try:
            live = await client.open_stream("ptu.inference")
            await live.send({"uids": _uids(server), "max_length": 8, "batch_size": 1, "session_id": "s1"})
            await live.recv(timeout=60)
            await live.send({"tensors": {"hidden": hidden}})
            await live.recv(timeout=60)
            assert await server.drain(migrate=False) == 1
            await live.send({"tensors": {"hidden": hidden}})
            await _expect_error(live, "Server is draining: migrate this session via ptu.session_export")
            fresh = await client.open_stream("ptu.inference")
            await fresh.send({"uids": _uids(server), "max_length": 8, "batch_size": 1})
            await _expect_error(fresh, "Server is draining: not accepting new sessions")
            with pytest.raises(Exception, match="not accepting migrated sessions"):
                await client.call("ptu.session_migrate", {
                    "session_id": "x", "start": 0, "end": N_LAYERS, "position": 1, "batch_size": 1,
                    "max_length": 8, "tensors": {}})
            reply = await client.call("ptu.session_export", {"session_id": "s1", "start": 0, "end": N_LAYERS})
            assert reply["position"] == 3 and reply["tensors"]["k"]["shape"][:3] == [N_LAYERS, 1, 3]
        finally:
            await client.close()

    try:
        route.loop.run(check())
    finally:
        route.stop()


def test_seed_by_import_stale_export_tops_up_with_replay():
    """A parked export can lag the client's position: the import cuts at a
    history STEP boundary (hypo_ids reorders are atomic) and replays the rest."""
    import torch

    class FakeServerSession:
        def __init__(self):
            self.history, self.imported, self.stepped = [], None, []

            class _Span:
                start, end = 0, 4

                class peer_id:
                    @staticmethod
                    def to_string():
                        return "fakepeer0"

            self.span = _Span()

        async def import_kv(self, k, v, position):
            self.imported = (tuple(k.shape), tuple(v.shape), position)

        async def step(self, chunk, prompts=None, hypo_ids=None, step_id=None):
            self.stepped.append(chunk.shape[1])
            return chunk

    sess = InferenceSession.__new__(InferenceSession)
    sess._position = 7  # 5 (prefill) + 1 + 1
    sess._last_prompts = None
    replay_steps = [(torch.zeros(1, 5, 8), None), (torch.zeros(1, 1, 8), None), (torch.zeros(1, 1, 8), None)]
    k = torch.zeros(4, 1, 6, 2, 4)  # a stale export: 6 of 7 positions
    target = FakeServerSession()
    assert asyncio.run(sess._seed_by_import(target, (k, k.clone(), 6), replay_steps))
    # the cut lands on the 5 + 1 boundary (<= 6), the last 1-token step replays
    assert target.imported == ((4, 1, 6, 2, 4), (4, 1, 6, 2, 4), 6)
    assert target.stepped == [1]
    assert len(target.history) == 2  # the seeded prefix; the stub's step appends nothing
    # an export AHEAD of the client is never imported (replay is exact)
    ahead = FakeServerSession()
    assert not asyncio.run(sess._seed_by_import(ahead, (k, k, 8), replay_steps))
    assert ahead.imported is None


def test_live_route_upgrade(model_path, tmp_path, monkeypatch):
    """A faster server joins mid-generation: the session moves its KV onto
    it (a live export from the old server, no prefill recomputed) and keeps
    producing HF's tokens."""
    from petals_tpu_torch.server.server import Server

    route = Route(model_path, [("port", 0, N_LAYERS, dict(throughput=1.0))], str(tmp_path)).start()
    model = port_client(model_path, route, route_upgrade_period=0.01)
    migrations = []
    real_seed = InferenceSession._seed_by_import

    async def spy_seed(self, session, exported, replay_steps):
        ok = await real_seed(self, session, exported, replay_steps)
        migrations.append(ok)
        return ok

    monkeypatch.setattr(InferenceSession, "_seed_by_import", spy_seed)
    try:
        ids = np.random.RandomState(2).randint(0, 100, (1, 5)).astype(np.int64)
        expected = hf_greedy(model_path, ids, 6)
        with model.remote.inference_session(max_length=16, batch_size=1) as session:
            first = model.generate(ids, max_new_tokens=3, session=session)
            np.testing.assert_array_equal(first, expected[:, :8])
            assert same_peer(session._session._sessions[0].span.peer_id, route.servers[0].dht.peer_id)

            async def add_fast():
                import torch

                server = Server(
                    model_path, first_block=0, num_blocks=N_LAYERS, initial_peers=route.initial_peers,
                    device="cpu", compute_dtype=torch.float32, throughput=1000.0,
                )
                await server.start()
                route.servers.append(server)

            route.loop.run(add_fast())
            final = model.generate(first, max_new_tokens=3, session=session)
            np.testing.assert_array_equal(final, expected)
            assert migrations and all(migrations), "the upgrade must seed by KV import"
            assert same_peer(session._session._sessions[0].span.peer_id, route.servers[1].dht.peer_id), (
                "the session should now ride the fast server"
            )
    finally:
        model.close()
        route.stop()


# ------------------------------------------------------------- migrate abort
#
# A drain-to-migrate push may meet a slow or partitioned peer. It must never
# hang teardown: shutdown() sets the abort signal, and the push's deadline
# covers the whole push. The parked entry stays, so clients still repair by
# export or replay. The delay is a push connection held back.


def hold_pushes(monkeypatch, server, seconds: float) -> None:
    pool = server.handler._push_pool
    real_get_addr = pool.get_addr

    async def slow_get_addr(addr):
        await asyncio.sleep(seconds)
        return await real_get_addr(addr)

    monkeypatch.setattr(pool, "get_addr", slow_get_addr)


@pytest.fixture()
def open_session(model_path, tmp_path):
    """One live session of the port's client on the preferred of two port
    servers."""
    route = Route(
        model_path, [("port", 0, N_LAYERS, dict(throughput=1000.0)), ("port", 0, N_LAYERS, dict(throughput=1.0))],
        str(tmp_path),
    ).start()
    model = port_client(model_path, route)
    session_cm = model.remote.inference_session(max_length=16, batch_size=1)
    session = session_cm.__enter__()
    model.generate(np.random.RandomState(3).randint(0, 100, (1, 5)).astype(np.int64), max_new_tokens=2,
                   session=session)
    fast = route.servers[0]
    assert same_peer(session._session._sessions[0].span.peer_id, fast.dht.peer_id)
    yield route, fast
    session_cm.__exit__(None, None, None)
    model.close()
    route.stop()


def test_shutdown_aborts_inflight_migration(open_session, monkeypatch):
    """shutdown() during a held-back migration push aborts it promptly
    instead of letting the drain wait out the slow peer."""
    route, fast = open_session
    hold_pushes(monkeypatch, fast, 60.0)
    drain = asyncio.run_coroutine_threadsafe(fast.drain(migrate=True), route.loop.loop)
    time.sleep(1.0)  # the push is waiting on its connection
    t0 = time.monotonic()
    route.loop.run(fast.shutdown())
    parked = drain.result(timeout=30)
    elapsed = time.monotonic() - t0
    route.servers.remove(fast)  # stop() must not shut it down twice
    assert parked == 1
    assert elapsed < 15.0, f"shutdown waited out the migration push ({elapsed:.1f} s)"
    stats = fast.handler.migration_stats
    assert stats["push_failures"] == 1 and stats["pushes"] == 0
    assert len(fast.handler._parked) == 1 and not fast.handler._migrated_away


def test_migration_push_deadline_covers_delay(open_session, monkeypatch):
    """The push's deadline bounds the whole push: a delay longer than
    ``deadline_s`` aborts it, and the session stays parked for the client's
    export."""
    route, fast = open_session
    assert route.loop.run(fast.drain(migrate=False)) == 1
    hold_pushes(monkeypatch, fast, 30.0)
    t0 = time.monotonic()
    pushed = route.loop.run(fast._migrate_parked_sessions(deadline_s=0.5))
    elapsed = time.monotonic() - t0
    assert pushed == 0, "an aborted push must not count as migrated"
    assert elapsed < 10.0, f"the deadline did not bound the held-back push ({elapsed:.1f} s)"
    assert fast.handler.migration_stats["push_failures"] == 1
    assert len(fast.handler._parked) == 1  # the parked copy survives: export or replay still work


def test_cli_takes_drain_and_phase_tier(model_path):
    """The port's CLI parses --drain_seconds and --phase_tier with
    petals_tpu's defaults and hands the tier to the Server."""
    from petals_tpu.cli.run_server import build_parser as jax_parser
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    defaults, theirs = build_parser().parse_args([model_path]), jax_parser().parse_args([model_path])
    assert (defaults.drain_seconds, defaults.phase_tier) == (theirs.drain_seconds, theirs.phase_tier) == (0.0, "generalist")
    args = build_parser().parse_args([model_path, "--drain_seconds", "12.5", "--phase_tier", "decode", "--device", "cpu",
                                      "--throughput", "1"])
    assert args.drain_seconds == 12.5
    assert build_server(args).phase_tier == "decode"
    with pytest.raises(SystemExit):
        build_parser().parse_args([model_path, "--phase_tier", "fast"])
