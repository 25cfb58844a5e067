"""Mid-generation failover of the port's client (the redundant swarm of
tests/test_failover.py, with port Servers on the CPU): two servers hold
tiny-llama's whole span, the preferred one (throughput 1000) dies
mid-generation, and the session repairs its chain onto the understudy by
replaying its recorded history; the stream equals the undisturbed one, and
HF's, greedy and 2-beam (whose replay repeats each step's hypo_ids).

Function-scoped swarms: each test kills a server. Every wait is bounded."""

import numpy as np
import pytest
import torch

from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from tests.test_torch_client import Route, hf_greedy
from tests.utils import make_tiny_llama

N_LAYERS = 4

pytestmark = pytest.mark.timeout(300)


@pytest.fixture()
def redundant_swarm(tmp_path_factory):
    path = make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)
    route = Route(
        path,
        [("port", 0, N_LAYERS, dict(throughput=1000.0)),  # preferred
         ("port", 0, N_LAYERS, dict(throughput=1.0))],  # understudy
        str(tmp_path_factory.mktemp("cache")),
        server_side_generation=False,  # the per-token path (a failed generated chunk: test_torch_client_jax.py)
    ).start()
    model = AutoDistributedModelForCausalLM.from_pretrained(
        path, initial_peers=route.initial_peers, device="cpu", min_backoff=0.1,
    )
    yield path, route, model
    model.close()
    route.stop()


def _kill(route, server):
    route.loop.run(server.shutdown())
    route.servers.remove(server)


def test_failover_mid_generation_replays_history(redundant_swarm):
    path, route, model = redundant_swarm
    preferred, understudy = route.servers
    ids = np.random.RandomState(0).randint(0, 100, (1, 5)).astype(np.int64)
    undisturbed = model.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(undisturbed, hf_greedy(path, ids, 6))

    with model.remote.inference_session(max_length=16, batch_size=1) as session:
        first = model.generate(ids, max_new_tokens=3, session=session)
        np.testing.assert_array_equal(first, undisturbed[:, :8])
        inner = session._session
        assert inner._sessions[0].span.peer_id.to_string() == preferred.dht.peer_id.to_string(), (
            "test setup: the high-throughput server should be chosen"
        )
        _kill(route, preferred)
        final = model.generate(first, max_new_tokens=3, session=session)
        # the session now runs on the understudy, its cache rebuilt by replay
        assert [s.span.peer_id.to_string() for s in inner._sessions] == [understudy.dht.peer_id.to_string()]
        assert inner._retired_hops and inner.position == 10
    np.testing.assert_array_equal(final, undisturbed)


def test_failover_during_beam_search(redundant_swarm):
    """The preferred server dies between beam steps inside one session: the
    replay must repeat each recorded step's hypo_ids reorder."""
    from transformers import AutoModelForCausalLM

    path, route, model = redundant_swarm
    ids = np.random.RandomState(4).randint(0, 100, (1, 4)).astype(np.int64)
    hf = AutoModelForCausalLM.from_pretrained(path, dtype=torch.float32).eval()
    with torch.no_grad():
        expected = hf.generate(torch.from_numpy(ids), max_new_tokens=6, num_beams=2, do_sample=False).numpy()
    undisturbed = model.generate(ids, max_new_tokens=6, num_beams=2)
    np.testing.assert_array_equal(undisturbed, expected)

    victim = route.servers[0]
    state = {"steps": 0, "killed": False}
    orig_inference_session = model.remote.inference_session

    def hooked_inference_session(**kwargs):
        session = orig_inference_session(**kwargs)
        orig_step = session.step

        def step(*args, **step_kwargs):
            state["steps"] += 1
            if state["steps"] == 3 and not state["killed"]:
                # the prefill and one beam step (with hypo_ids) are recorded
                state["killed"] = True
                _kill(route, victim)
            return orig_step(*args, **step_kwargs)

        session.step = step
        return session

    model.remote.inference_session = hooked_inference_session
    out = model.generate(ids, max_new_tokens=6, num_beams=2)
    assert state["killed"], "test setup: the kill hook never fired"
    np.testing.assert_array_equal(out, undisturbed)
