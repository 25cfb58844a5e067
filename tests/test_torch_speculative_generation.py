"""Client-side speculative decoding of the port (client/speculative.py,
``DistributedModelForSpeculativeGeneration``), ported from
tests/test_speculative_generation.py, and the clients against a port
server that speculates itself (``--draft_model``): every output must be
plain greedy decoding's token for token, whatever the draft proposes, and
a session rolled back past rejected drafts stays usable.

Three routes over tiny llama's 4 blocks, each a swarm of its own: a port
server, a petals_tpu server, and a port server with the tiny model drafting
for itself (unquantized, the reference's ``spec_swarm``). The port client
runs on the CPU; petals_tpu's client drives the third route too."""

import numpy as np
import pytest

from tests.test_full_model import _hf_greedy
from tests.test_torch_client import Route
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)

NEW_TOKENS = 8
SPEC_K = 3


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")))


@pytest.fixture(scope="module")
def routes(model_path, tmp_path_factory):
    """name -> (route, port client): "port" and "jax" serve plain; "spec" is
    a port server with a draft on a paged 3-lane pool."""
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM

    spec = dict(batch_lanes=3, batch_max_length=64, page_size=8, draft_model=model_path, spec_k=SPEC_K,
                draft_quant_type="none", draft_window=48)
    out = {}
    for name, specs in (("port", [("port", 0, 4)]), ("jax", [("jax", 0, 4)]), ("spec", [("port", 0, 4, spec)])):
        route = Route(model_path, specs, str(tmp_path_factory.mktemp(f"cache-{name}"))).start()
        out[name] = (route, AutoDistributedModelForCausalLM.from_pretrained(
            model_path, initial_peers=route.initial_peers, device="cpu"))
    yield out
    for route, model in out.values():
        model.close()
        route.stop()


def _ids(seed, n=5):
    return np.random.RandomState(seed).randint(0, 100, (1, n)).astype(np.int64)


@pytest.mark.parametrize("name", ["port", "jax"])
def test_oracle_draft_token_identical(routes, model_path, name):
    """A perfect draft (the same model run locally on the CPU) accepts
    everything; the output is HF's greedy."""
    from petals_tpu_torch.client.speculative import make_local_draft_fn, speculative_generate

    _, model = routes[name]
    ids = _ids(0)
    draft = make_local_draft_fn(model_path, device="cpu")
    out = speculative_generate(model, draft, ids, max_new_tokens=NEW_TOKENS, speculative_tokens=3)
    np.testing.assert_array_equal(out, _hf_greedy(model_path, ids, NEW_TOKENS))


@pytest.mark.parametrize("name", ["port", "jax"])
def test_junk_draft_still_token_identical(routes, model_path, name):
    """Garbage proposals cost rollbacks, never tokens."""
    from petals_tpu_torch.client.speculative import speculative_generate

    _, model = routes[name]
    ids = _ids(1)
    junk_rng = np.random.RandomState(99)
    out = speculative_generate(model, lambda context, k: junk_rng.randint(0, 100, size=k).astype(np.int64), ids,
                               max_new_tokens=NEW_TOKENS, speculative_tokens=4)
    np.testing.assert_array_equal(out, _hf_greedy(model_path, ids, NEW_TOKENS))


@pytest.mark.parametrize("name", ["port", "jax"])
def test_partial_acceptance_and_session_after_rollback(routes, model_path, name):
    """A draft right for one token and then wrong rolls each verify back
    mid-chunk (``start_from_position`` on the server); the same session
    then generates on, plain, and matches HF's continuation."""
    from petals_tpu_torch.client.speculative import speculative_generate

    _, model = routes[name]
    ids = _ids(2, 4)
    expected = _hf_greedy(model_path, ids, 2 * NEW_TOKENS)
    truth = expected[0, ids.shape[1]:]
    calls = {"n": 0}

    def half_right_draft(context, k):
        pos = len(context) - ids.shape[1]
        calls["n"] += 1
        return np.asarray([truth[pos] if j == 0 and pos < len(truth) else 1 for j in range(k)], np.int64)

    session = model.remote.inference_session(max_length=64)
    try:
        out = speculative_generate(model, half_right_draft, ids, max_new_tokens=NEW_TOKENS, speculative_tokens=3,
                                   session=session)
        np.testing.assert_array_equal(out, expected[:, : ids.shape[1] + NEW_TOKENS])
        assert calls["n"] >= 2
        # the session rolled back mid-chunk: its last token is pending, its
        # caches hold everything before it
        assert session.position == out.shape[1] - 1
        more = speculative_generate(model, lambda context, k: np.ones(k, np.int64), out,
                                    max_new_tokens=NEW_TOKENS, speculative_tokens=2, session=_Continuing(session))
        np.testing.assert_array_equal(more, expected)
    finally:
        session.close()


class _Continuing:
    """A session whose prompt is already cached but for its last token: the
    continuation's prefill step (all but the last token) is skipped."""

    def __init__(self, session):
        self._session = session
        self._skip = True

    def step(self, hidden, **kwargs):
        if self._skip:
            self._skip = False
            return None
        return self._session.step(hidden, **kwargs)

    @property
    def position(self):
        return self._session.position

    @position.setter
    def position(self, value):
        self._session.position = value


def test_full_acceptance_no_duplicates(routes, model_path):
    """The true continuation as the draft: the all-accepted branch runs
    every step, and the last accepted draft is not emitted twice."""
    from petals_tpu_torch.client.speculative import speculative_generate

    _, model = routes["port"]
    ids = _ids(3)
    expected = _hf_greedy(model_path, ids, NEW_TOKENS)
    truth = expected[0, ids.shape[1]:]

    def oracle(context, k):
        pos = len(context) - ids.shape[1]
        return np.asarray(truth[pos : pos + k], np.int64)

    out = speculative_generate(model, oracle, ids, max_new_tokens=NEW_TOKENS, speculative_tokens=3)
    np.testing.assert_array_equal(out, expected)


@pytest.mark.parametrize("name", ["port", "jax"])
def test_speculative_model_class(routes, model_path, name):
    """``DistributedModelForSpeculativeGeneration`` (a local draft beside
    the swarm's blocks) gives plain greedy's tokens."""
    from petals_tpu_torch.client.model import DistributedModelForSpeculativeGeneration

    route, _ = routes[name]
    spec_model = DistributedModelForSpeculativeGeneration.from_pretrained(
        model_path, model_path, initial_peers=route.initial_peers, device="cpu", speculative_tokens=3)
    try:
        ids = _ids(7)
        np.testing.assert_array_equal(spec_model.generate(ids, max_new_tokens=NEW_TOKENS),
                                      _hf_greedy(model_path, ids, NEW_TOKENS))
    finally:
        spec_model.close()


def test_jax_client_speculates_against_a_drafting_port_server(routes, model_path):
    """petals_tpu's client over the port server that drafts for itself: its
    own ``speculative_generate`` (a junk draft, rolled back every step) and
    its ``generate``, whose server-side fast path now speculates on the
    server (the prompt rides as the draft's context), both give HF's greedy
    tokens; seeded sampling repeats; the server's spec steps ran and
    accepted drafts. The port client's ``generate`` gives the same."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient
    from petals_tpu.client.speculative import speculative_generate as jax_speculative_generate

    route, port_model = routes["spec"]
    batcher = route.servers[0].batcher
    jax_model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
    try:
        ids = _ids(41, 6)
        want = _hf_greedy(model_path, ids, 12)
        junk = np.random.RandomState(5)
        out = jax_speculative_generate(jax_model, lambda c, k: junk.randint(0, 100, size=k).astype(np.int64), ids,
                                       max_new_tokens=12, speculative_tokens=3)
        np.testing.assert_array_equal(out, want)
        spec0, acc0 = batcher.stats["spec_steps"], batcher.stats["spec_accepted"]
        np.testing.assert_array_equal(jax_model.generate(ids, max_new_tokens=12), want)
        assert batcher.stats["spec_steps"] > spec0 and batcher.stats["spec_accepted"] > acc0
        np.testing.assert_array_equal(np.asarray(port_model.generate(ids, max_new_tokens=12)), want)
        case = dict(do_sample=True, temperature=0.8, top_k=10, seed=77)
        a = np.asarray(jax_model.generate(ids, max_new_tokens=10, **case))
        b = np.asarray(port_model.generate(ids, max_new_tokens=10, **case))
        np.testing.assert_array_equal(a, b)
    finally:
        jax_model.close()


def test_drafting_port_server_is_announced_with_spec_k(routes, model_path):
    """petals_tpu reads ``spec_k`` from the drafting port server's announce
    in the DHT, and none from the plain port server's."""
    from petals_tpu.dht import DHTNode as JaxDHTNode
    from petals_tpu.utils.dht_utils import get_remote_module_infos
    from petals_tpu_torch.data_structures import make_uid
    from petals_tpu_torch.server.server import default_dht_prefix

    uids = [make_uid(default_dht_prefix(model_path), i) for i in range(4)]
    for name, want in (("spec", SPEC_K), ("port", None)):
        route = routes[name][0]

        async def read():
            reader = await JaxDHTNode.create(initial_peers=route.initial_peers, client_mode=True)
            try:
                return await get_remote_module_infos(reader, uids)
            finally:
                await reader.shutdown()

        infos, _ = route.loop.run(read())
        for info in infos:
            (server_info,) = info.servers.values()
            assert server_info.spec_k == want, name
            assert server_info.server_gen is True
