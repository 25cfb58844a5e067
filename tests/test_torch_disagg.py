"""Disaggregated prefill/decode serving with port servers
(tests/test_disagg.py's two-server handoff, with one or both servers, and
the client, swapped for the port's).

A prefill-tier and a decode-tier server hold tiny-llama's whole span
(server-side generation off, so the client runs its per-token path and the
handoff fires at the first step's boundary). A session whose first step
carries at least ``prefill_tier_tokens`` tokens routes onto the prefill
tier; after that step the client asks the source for
``ptu.session_handoff``, the source pushes the KV to the decode replica over
``ptu.session_migrate``, and a fresh session there adopts it (``kv_adopt``):

- greedy decoding stays HF's, lands on the decode replica, adopts once and
  replays nothing: the port's client over two port servers, and
  petals_tpu's client from a petals_tpu prefill server to a port decode
  server and back; the ledger bills the pushed bytes both ways;
- seeded sampling through a handoff equals the same seed decoded where it
  prefilled (``disagg_handoff=False``);
- the source is left clean: no live or parked session, no busy lane, every
  page free;
- a failed push (its connection refused) degrades to decoding on the
  prefill replica, with no replay;
- ``phase_tier`` crosses the announce both ways, and is absent-safe.

Every wait is bounded."""

import time

import numpy as np
import pytest

from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from petals_tpu_torch.client.inference_session import InferenceSession
from tests.test_torch_client import Route, hf_greedy
from tests.utils import make_tiny_llama

N_LAYERS = 4
SAMPLING = dict(do_sample=True, top_k=10, temperature=0.8, seed=7)

pytestmark = pytest.mark.timeout(600)

# (prefill server, decode server, client)
PAIRS = {"port": ("port", "port", "port"), "jax_to_port": ("jax", "port", "jax"), "port_to_jax": ("port", "jax", "jax")}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module", params=sorted(PAIRS))
def tiered_swarm(request, model_path, tmp_path_factory):
    prefill_kind, decode_kind, client_kind = PAIRS[request.param]
    route = Route(
        model_path,
        [(prefill_kind, 0, N_LAYERS, dict(throughput=1000.0, phase_tier="prefill")),
         (decode_kind, 0, N_LAYERS, dict(throughput=1000.0, phase_tier="decode"))],
        str(tmp_path_factory.mktemp("cache")), server_side_generation=False,
    ).start()
    yield request.param, client_kind, route
    route.stop()


def make_client(kind, path, route, **overrides):
    config = dict(initial_peers=route.initial_peers, min_backoff=0.1, prefill_tier_tokens=4, **overrides)
    if kind == "port":
        return AutoDistributedModelForCausalLM.from_pretrained(path, device="cpu", **config)
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    return JaxClient.from_pretrained(path, **config)


def spy_handoff_paths(monkeypatch, kind):
    if kind == "port":
        cls = InferenceSession
    else:
        from petals_tpu.client.inference_session import InferenceSession as cls
    adopts, replays = [], []
    real_adopt, real_replay = cls._seed_by_adopt, cls._replay_step

    async def spy_adopt(self, session, source_session_id, export_pos, replay_steps):
        ok = await real_adopt(self, session, source_session_id, export_pos, replay_steps)
        adopts.append(ok)
        return ok

    async def spy_replay(self, session, chunk, hypo_step, step_id):
        replays.append(step_id)
        return await real_replay(self, session, chunk, hypo_step, step_id)

    monkeypatch.setattr(cls, "_seed_by_adopt", spy_adopt)
    monkeypatch.setattr(cls, "_replay_step", spy_replay)
    return adopts, replays


def peers(session):
    return [s.span.peer_id.to_string() for s in session._session._sessions]


def migrated_total():
    """Migrated bytes both ledgers (port and petals_tpu) billed so far."""
    from petals_tpu.telemetry.ledger import get_ledger as jax_ledger
    from petals_tpu_torch.telemetry.ledger import get_ledger

    return sum(r["migrated_bytes"] for ledger in (get_ledger(), jax_ledger()) for r in ledger.top_peers(k=100))


def test_handoff_token_parity_greedy(tiered_swarm, model_path, monkeypatch):
    """Greedy decoding after a handoff stays HF's, on the decode replica,
    with one adopt, no replay, and the pushed bytes billed as migration
    bytes at both ends."""
    name, client_kind, route = tiered_swarm
    prefill, decode = route.servers
    adopts, replays = spy_handoff_paths(monkeypatch, client_kind)
    port_source = hasattr(prefill.handler, "migration_stats")
    pushed0 = prefill.handler.migration_stats["push_bytes"] if port_source else None
    migrated0 = migrated_total()
    model = make_client(client_kind, model_path, route)
    try:
        ids = np.random.RandomState(0).randint(0, 100, (1, 6)).astype(np.int64)
        expected = hf_greedy(model_path, ids, 6)
        with model.remote.inference_session(max_length=16, batch_size=1) as session:
            np.testing.assert_array_equal(model.generate(ids, max_new_tokens=6, session=session), expected)
            assert peers(session) == [decode.dht.peer_id.to_string()], "the session must decode on the decode tier"
            assert session._session._handoff_stats == {"adopted": 1, "fallback": 0, "replayed": 0}
    finally:
        model.close()
    assert adopts == [True]
    assert replays == [], "a step-boundary handoff never replays"
    if port_source:
        pushed = prefill.handler.migration_stats["push_bytes"] - pushed0
        assert pushed > 0
        # the source's rollup bills the pushed bytes, the destination's live
        # session the adopted ones: the same wire bytes twice
        assert migrated_total() - migrated0 == 2 * pushed
    else:
        assert migrated_total() > migrated0


def test_handoff_token_parity_seeded_sampling(tiered_swarm, model_path):
    """Seeded sampling through a handoff equals the same seed decoded
    colocated: the adopted KV is exact."""
    name, client_kind, route = tiered_swarm
    prefill, decode = route.servers

    def sample(disagg: bool):
        model = make_client(client_kind, model_path, route, disagg_handoff=disagg)
        try:
            ids = np.random.RandomState(1).randint(0, 100, (1, 6)).astype(np.int64)
            with model.remote.inference_session(max_length=16, batch_size=1) as session:
                out = model.generate(ids, max_new_tokens=5, session=session, **SAMPLING)
                return np.asarray(out), peers(session)
        finally:
            model.close()

    with_handoff, handoff_peers = sample(True)
    colocated, colocated_peers = sample(False)
    np.testing.assert_array_equal(with_handoff, colocated)
    assert handoff_peers == [decode.dht.peer_id.to_string()]
    assert colocated_peers == [prefill.dht.peer_id.to_string()], "without the handoff the session stays put"


def test_handoff_source_left_clean(tiered_swarm, model_path):
    """After the handoff and the session's close, the source holds no live
    or parked session, no busy lane, and its whole page pool is free."""
    name, client_kind, route = tiered_swarm
    model = make_client(client_kind, model_path, route)
    try:
        ids = np.random.RandomState(2).randint(0, 100, (1, 6)).astype(np.int64)
        with model.remote.inference_session(max_length=16, batch_size=1) as session:
            model.generate(ids, max_new_tokens=4, session=session)
            assert session._session._handoff_stats["adopted"] == 1
    finally:
        model.close()
    source = route.servers[0].handler
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        pool = source.batcher.occupancy_info()
        if not source._session_registry and not source._parked and pool.get("busy_lanes", 0) == 0:
            break
        time.sleep(0.2)
    assert not source._session_registry, "a live session leaked on the source"
    assert not source._parked, "a parked snapshot leaked on the source"
    pool = source.batcher.occupancy_info()
    assert pool.get("busy_lanes", 0) == 0, f"source lanes still busy: {pool}"
    assert pool["pages_free"] == pool["n_pages"], f"the handed-off KV leaked pages on the source: {pool}"


def test_failed_handoff_push_degrades_to_colocated(tiered_swarm, model_path, monkeypatch):
    """A refused push: the source reports the failure, the client decodes
    on the prefill replica, HF's tokens, no session lost, no replay."""
    name, client_kind, route = tiered_swarm
    prefill, decode = route.servers
    adopts, replays = spy_handoff_paths(monkeypatch, client_kind)
    stats = getattr(prefill.handler, "migration_stats", None)  # the port's
    failures0 = stats["push_failures"] if stats is not None else None

    async def refuse(addr):
        raise ConnectionRefusedError("handoff push refused")

    monkeypatch.setattr(prefill.handler._push_pool, "get_addr", refuse)
    model = make_client(client_kind, model_path, route)
    try:
        ids = np.random.RandomState(3).randint(0, 100, (1, 6)).astype(np.int64)
        with model.remote.inference_session(max_length=16, batch_size=1) as session:
            np.testing.assert_array_equal(model.generate(ids, max_new_tokens=6, session=session),
                                          hf_greedy(model_path, ids, 6))
            assert peers(session) == [prefill.dht.peer_id.to_string()], "a failed handoff decodes at the source"
            assert session._session._handoff_stats == {"adopted": 0, "fallback": 1, "replayed": 0}
    finally:
        model.close()
    assert adopts == [] and replays == []
    if stats is not None:
        assert stats["push_failures"] == failures0 + 1


def test_phase_tier_announce_roundtrip(tiered_swarm):
    """phase_tier survives the ServerInfo wire both ways between the
    packages, is absent-safe, and a live server's announce carries it."""
    from petals_tpu.data_structures import ServerInfo as JaxInfo
    from petals_tpu.data_structures import ServerState as JaxState
    from petals_tpu_torch.data_structures import ServerInfo, ServerState
    from petals_tpu_torch.server.server import Server

    info = ServerInfo(ServerState.ONLINE, 1.0, phase_tier="decode")
    assert ServerInfo.from_tuple(info.to_tuple()).phase_tier == "decode"
    assert JaxInfo.from_tuple(info.to_tuple()).phase_tier == "decode"
    theirs = JaxInfo(JaxState.ONLINE, 1.0, phase_tier="prefill")
    assert ServerInfo.from_tuple(theirs.to_tuple()).phase_tier == "prefill"
    assert ServerInfo.from_tuple(ServerInfo(ServerState.ONLINE, 1.0).to_tuple()).phase_tier is None
    name, _, route = tiered_swarm
    tiers = {s._server_info(ServerState.ONLINE).phase_tier for s in route.servers if isinstance(s, Server)}
    assert tiers == {"port": {"prefill", "decode"}, "jax_to_port": {"decode"}, "port_to_jax": {"prefill"}}[name]
