"""The port's client against petals_tpu's client, on the CPU:

- two petals_tpu Servers on tiny-llama's halves: every case of
  tests/test_torch_client.py, array for array (a chain of two spans: no
  server-side generation path for either client);
- one whole-model petals_tpu Server, and one whole-model port Server:
  greedy, seeded sampling and greedy with a repetition penalty, each also
  in a chat session and stopped by an eos inside a chunk with a streamer.
  There both clients take their server-side generation path
  (``generate_remote``, spied on), and their streams (and the streamer's
  pieces) are equal array for array; greedy also equals HF's. A
  petals_tpu client over the port server emits the streams it gets from
  the petals_tpu server;
- two whole-model port servers, the preferred one failing its second
  generated chunk: the port client repairs the route by replay and
  finishes per token with the undisturbed stream's tokens, greedy and
  sampled."""

import numpy as np
import pytest

from tests.test_torch_client import (
    CASES,
    N_LAYERS,
    SAMPLING,
    Recorder,
    Route,
    _ids,
    assert_same_streams,
    both_clients,
    hf_greedy,
)
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def jax_route(model_path, tmp_path_factory):
    half = N_LAYERS // 2
    route = Route(model_path, [("jax", 0, half), ("jax", half, half)], str(tmp_path_factory.mktemp("cache"))).start()
    jax_model, port_model = both_clients(model_path, route.initial_peers)
    yield route, jax_model, port_model
    port_model.close()
    jax_model.close()
    route.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_port_client_equals_jax_client_over_two_petals_tpu_servers(jax_route, case):
    assert_same_streams(jax_route[1], jax_route[2], case)


FASTPATH_CASES = {
    "greedy": dict(),
    "sampled": dict(SAMPLING),
    "penalty": dict(repetition_penalty=1.3),
}


def _spy_generate_remote(monkeypatch):
    """Record, for each client package, whether each ``generate_remote``
    call was served (it returns None when the route cannot generate)."""
    from petals_tpu.client.remote_sequential import SyncInferenceSession as JaxSync
    from petals_tpu_torch.client.remote_sequential import SyncInferenceSession

    served = {"jax": [], "port": []}
    for name, cls in (("jax", JaxSync), ("port", SyncInferenceSession)):
        original = cls.generate_remote

        def spy(self, *args, _original=original, _name=name, **kwargs):
            tokens = _original(self, *args, **kwargs)
            served[_name].append(tokens is not None)
            return tokens

        monkeypatch.setattr(cls, "generate_remote", spy)
    return served


def _fastpath_streams(model, case):
    ids = _ids(1, (1, 6))
    kwargs = FASTPATH_CASES[case]
    first = model.generate(ids, max_new_tokens=8, **kwargs)
    # a chat: the second call continues the session from the pending token
    with model.inference_session(max_length=32):
        a = model.generate(ids, max_new_tokens=5, **kwargs)
        b = model.generate(a, max_new_tokens=5, **kwargs)
    # an eos inside a chunk: the stream stops there, the servers roll back so
    # that the eos is the pending token, and a streamer sees the chunk
    eos = int(first[0, ids.shape[1] + 2])
    rec = Recorder()
    with model.inference_session(max_length=32):
        c = model.generate(ids, max_new_tokens=8, eos_token_id=eos, streamer=rec, **kwargs)
        d = model.generate(c, max_new_tokens=4, **kwargs)
    assert rec.ended and c[0, -1] == eos
    return [first, a, b, c, d] + rec.chunks


def _both_take_the_fast_path(path, route, case, monkeypatch):
    served = _spy_generate_remote(monkeypatch)
    jax_model, port_model = both_clients(path, route.initial_peers)
    try:
        want = _fastpath_streams(jax_model, case)
        got = _fastpath_streams(port_model, case)
    finally:
        port_model.close()
        jax_model.close()
    assert served["jax"] and all(served["jax"]), served  # petals_tpu's client took its fast path
    assert served["port"] and all(served["port"]), served  # and so did the port's
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w, err_msg=f"{case}[{i}]")
    if case == "greedy":
        np.testing.assert_array_equal(got[0], hf_greedy(path, _ids(1, (1, 6)), 8))
    if case == "sampled":
        np.testing.assert_array_equal(got[0], _second_seeded_run(path, route))


def _second_seeded_run(path, route):
    """A second seeded run of a fresh port client: the same stream."""
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM

    model = AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=route.initial_peers, device="cpu")
    try:
        return model.generate(_ids(1, (1, 6)), max_new_tokens=8, **FASTPATH_CASES["sampled"])
    finally:
        model.close()


@pytest.fixture(scope="module")
def jax_full_route(model_path, tmp_path_factory):
    route = Route(model_path, [("jax", 0, N_LAYERS)], str(tmp_path_factory.mktemp("cache"))).start()
    yield route
    route.stop()


@pytest.fixture(scope="module")
def port_full_route(model_path, tmp_path_factory):
    route = Route(model_path, [("port", 0, N_LAYERS)], str(tmp_path_factory.mktemp("cache"))).start()
    yield route
    route.stop()


@pytest.mark.parametrize("case", list(FASTPATH_CASES))
def test_greedy_over_one_full_span_petals_tpu_server(model_path, jax_full_route, case, monkeypatch):
    _both_take_the_fast_path(model_path, jax_full_route, case, monkeypatch)


@pytest.mark.parametrize("case", list(FASTPATH_CASES))
def test_fast_path_over_one_full_span_port_server(model_path, port_full_route, case, monkeypatch):
    batcher = port_full_route.servers[0].batcher
    before = batcher.stats["gen_steps"]
    _both_take_the_fast_path(model_path, port_full_route, case, monkeypatch)
    assert batcher.stats["gen_steps"] > before  # the port server generated in its batcher


@pytest.mark.parametrize("case", list(FASTPATH_CASES))
def test_jax_client_over_a_port_server_emits_petals_tpu_streams(
    model_path, jax_full_route, port_full_route, case, monkeypatch
):
    """A petals_tpu client takes its server-side generation path to a port
    server, and the streams are the ones a petals_tpu server gives it."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    served = _spy_generate_remote(monkeypatch)
    streams = []
    for route in (jax_full_route, port_full_route):
        model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
        try:
            streams.append(_fastpath_streams(model, case))
        finally:
            model.close()
    assert served["jax"] and all(served["jax"])
    for g, w in zip(streams[1], streams[0]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["greedy", "sampled"])
def test_failed_chunk_falls_back_per_token_with_the_same_tokens(model_path, tmp_path_factory, case):
    """Two whole-model port servers; the preferred one fails the second
    chunk it is asked to generate. The client repairs its route by replay
    and finishes the stream per token (the sampled one on the server's own
    Threefry draws): the tokens equal the undisturbed stream's."""
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM

    route = Route(
        model_path, [("port", 0, N_LAYERS, dict(throughput=1000.0)), ("port", 0, N_LAYERS)],
        str(tmp_path_factory.mktemp("cache")),
    ).start()
    model = AutoDistributedModelForCausalLM.from_pretrained(
        model_path, initial_peers=route.initial_peers, device="cpu", min_backoff=0.1,
    )
    try:
        ids = _ids(2, (1, 5))
        kwargs = FASTPATH_CASES[case]
        undisturbed = model.generate(ids, max_new_tokens=40, **kwargs)  # chunks of 32 and 8
        preferred = route.servers[0].batcher
        calls, original = [], preferred.generate_lane

        async def fail_second(*args, **kw):
            calls.append(args[3])
            if len(calls) == 2:
                raise RuntimeError("planted failure of a generated chunk")
            return await original(*args, **kw)

        preferred.generate_lane = fail_second
        per_token = []
        step = model._host_logits

        def count(out):
            per_token.append(1)
            return step(out)

        model._host_logits = count
        disturbed = model.generate(ids, max_new_tokens=40, **kwargs)
        assert calls[:2] == [32, 8], calls
        assert len(per_token) == 8  # the tail after the failed chunk, per token
        np.testing.assert_array_equal(disturbed, undisturbed)
    finally:
        model.close()
        route.stop()
