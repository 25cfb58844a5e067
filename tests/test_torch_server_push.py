"""Server-to-server activation push with port servers (tests/test_server_push.py
with one or both servers of the chain swapped for the port's).

One swarm on the CPU holds tiny-llama's two halves twice: a petals_tpu
server and a port Server on [0, 2), the same on [2, 4). A client's
``allowed_servers`` pins each chain. Each server that opens a session with a
``push_to`` pushes every step's output to the next server's session
(``ptu.push``); the next server serves whichever copy of the ``step_id``
comes first, answers on the client's stream, and skips the other.

- The port's client over [port, port]: the greedy stream equals HF's, and
  pushes fired; with ``use_server_to_server=False`` none does and the stream
  is the same.
- petals_tpu's client with its default config over [JAX, port] and
  [port, JAX]: the greedy stream equals the all-JAX chain's, the receiving
  server (of each kind) served at least one pushed step, and the client's
  relayed copy of such a step was skipped. A petals_tpu server is watched
  through a wrapper of its ``_step_source`` (the test's, not the package's).

Which copy of a step comes first is a race on one host; the tests that
count pushed steps served hold the client's relay to the back server
``RELAY_DELAY_S`` back, so that the push wins it.

Every wait is bounded."""

import numpy as np
import pytest

from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from tests.test_torch_client import Route, hf_greedy
from tests.utils import make_tiny_llama

N_LAYERS = 4
RELAY_DELAY_S = 0.2

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def push_swarm(tmp_path_factory):
    path = make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)
    route = Route(
        path,
        [("jax", 0, 2), ("jax", 2, 2), ("port", 0, 2), ("port", 2, 2)],
        str(tmp_path_factory.mktemp("cache")),
    ).start()
    jax_front, jax_back, port_front, port_back = route.servers
    for server in (jax_front, jax_back):
        server.handler.push_counts = watch_pushes(server.handler)
    yield path, route, dict(jax_front=jax_front, jax_back=jax_back, port_front=port_front, port_back=port_back)
    route.stop()


def watch_pushes(handler) -> dict:
    """Count, on a petals_tpu handler, the steps served from a push and the
    duplicate copies skipped, by source (a wrapper of its step source)."""
    counts = {"pushed_steps_served": 0, "client_copies_skipped": 0, "pushed_copies_skipped": 0}
    orig = handler._step_source

    def source(requests, push_queue, timeout):
        pushed_ids = set()
        if push_queue is not None:
            real_get = push_queue.get

            async def get():
                item = await real_get()
                pushed_ids.add(id(item))
                return item

            push_queue.get = get
        next_step, cleanup = orig(requests, push_queue, timeout)
        seen = set()

        async def wrapped():
            step = await next_step()
            if step is not None and step.get("step_id") is not None:
                pushed = id(step) in pushed_ids
                if step["step_id"] in seen:
                    counts["pushed_copies_skipped" if pushed else "client_copies_skipped"] += 1
                else:
                    seen.add(step["step_id"])
                    counts["pushed_steps_served"] += pushed
            return step

        return wrapped, cleanup

    handler._step_source = source
    return counts


def counts_of(server) -> dict:
    stats = getattr(server.handler, "push_counts", None) or server.handler.migration_stats
    return {k: stats[k] for k in ("pushed_steps_served", "client_copies_skipped", "pushed_copies_skipped")}


def slow_relay(monkeypatch, session_cls):
    """Hold a client's steps to the back half (block 2 on) back a little."""
    import asyncio

    orig = session_cls.step

    async def step(self, *args, **kwargs):
        if self.span.start == N_LAYERS // 2:
            await asyncio.sleep(RELAY_DELAY_S)
        return await orig(self, *args, **kwargs)

    monkeypatch.setattr(session_cls, "step", step)


def pin(servers):
    return [s.dht.peer_id.to_string() for s in servers]


def test_push_fires_and_output_identical(push_swarm, monkeypatch):
    from petals_tpu_torch.client.inference_session import _ServerInferenceSession

    path, route, s = push_swarm
    slow_relay(monkeypatch, _ServerInferenceSession)
    before = counts_of(s["port_back"])
    model = AutoDistributedModelForCausalLM.from_pretrained(
        path, initial_peers=route.initial_peers, device="cpu", allowed_servers=pin([s["port_front"], s["port_back"]]),
    )
    try:
        ids = np.random.RandomState(0).randint(0, 100, (1, 5)).astype(np.int64)
        out = model.generate(ids, max_new_tokens=5)
        np.testing.assert_array_equal(out, hf_greedy(path, ids, 5))
    finally:
        model.close()
    after = counts_of(s["port_back"])
    served = after["pushed_steps_served"] - before["pushed_steps_served"]
    # every step of the 5 reaches the back server twice, one copy served and
    # one skipped (the last step's pushed copy may find the session closed)
    skipped = sum(after[k] - before[k] for k in ("client_copies_skipped", "pushed_copies_skipped"))
    assert served >= 1, "server-to-server pushes should have been served"
    assert skipped >= 4


def test_push_disabled_still_works(push_swarm):
    path, route, s = push_swarm
    before = counts_of(s["port_back"])
    model = AutoDistributedModelForCausalLM.from_pretrained(
        path, initial_peers=route.initial_peers, device="cpu", use_server_to_server=False,
        allowed_servers=pin([s["port_front"], s["port_back"]]),
    )
    try:
        ids = np.random.RandomState(1).randint(0, 100, (1, 4)).astype(np.int64)
        out = model.generate(ids, max_new_tokens=4)
        np.testing.assert_array_equal(out, hf_greedy(path, ids, 4))
    finally:
        model.close()
    assert counts_of(s["port_back"]) == before, "no push without use_server_to_server"


@pytest.mark.parametrize("chain", ["jax_port", "port_jax"])
def test_mixed_push_chain_equals_all_jax(push_swarm, chain, monkeypatch):
    """petals_tpu's client with its defaults (use_server_to_server on) over
    a mixed chain: the same greedy stream as over the all-JAX chain, and
    the receiving server served pushed steps and skipped the client's
    copies of them."""
    from petals_tpu.client.inference_session import _ServerInferenceSession as JaxSession
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    path, route, s = push_swarm
    slow_relay(monkeypatch, JaxSession)
    front, back = (s["jax_front"], s["port_back"]) if chain == "jax_port" else (s["port_front"], s["jax_back"])
    ids = np.random.RandomState(2).randint(0, 100, (1, 6)).astype(np.int64)
    streams = {}
    for name, pair in (("jax", [s["jax_front"], s["jax_back"]]), (chain, [front, back])):
        before = counts_of(back)
        model = JaxClient.from_pretrained(path, initial_peers=route.initial_peers, allowed_servers=pin(pair))
        try:
            assert model.remote.sequence_manager.config.use_server_to_server
            streams[name] = model.generate(ids, max_new_tokens=8)
        finally:
            model.close()
    after = counts_of(back)
    np.testing.assert_array_equal(streams[chain], streams["jax"])
    np.testing.assert_array_equal(streams["jax"], hf_greedy(path, ids, 8))
    assert after["pushed_steps_served"] - before["pushed_steps_served"] >= 1, after
    assert after["client_copies_skipped"] - before["client_copies_skipped"] >= 1, after
