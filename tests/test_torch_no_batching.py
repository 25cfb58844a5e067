"""``--no_batching`` (petals_tpu/server/handler.py:155): a port Server with
``batching=False`` has no lane pool and serves every session from a
private cache. Two concurrent sessions through the port's client, greedy
and seeded-sampled, with server-side generation on and off, give the
streams a petals_tpu ``--no_batching`` server gives; ``ptu.info`` answers
without the pool's fields, as petals_tpu's does."""

import threading

import numpy as np
import pytest

from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from tests.test_torch_client import SAMPLING, Route
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)

N_LAYERS = 2


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def _ids(seed):
    return np.random.RandomState(seed).randint(1, 100, (1, 4 + seed % 3)).astype(np.int64)


def _two_sessions_at_once(path, route, sampling):
    """Two port clients generating at the same time (each its own session)."""
    models = [AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=route.initial_peers, device="cpu")
              for _ in range(2)]
    outs, errors = [None, None], []
    barrier = threading.Barrier(2)

    def run(i):
        try:
            barrier.wait(10)
            outs[i] = models[i].generate(_ids(i + 1), max_new_tokens=6, **sampling)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        for m in models:
            m.close()
    assert not errors, errors
    return outs


def _streams(path, route):
    return {name: _two_sessions_at_once(path, route, sampling)
            for name, sampling in (("greedy", {}), ("sampled", SAMPLING))}


@pytest.fixture(scope="module", params=[True, False], ids=["server_gen", "per_token"])
def expected(request, model_path, tmp_path_factory):
    """The streams of a petals_tpu --no_batching server (a sampled stream
    generated on the server draws its own Threefry uniforms, so each mode
    is held to its own)."""
    route = Route(model_path, [("jax", 0, N_LAYERS)], str(tmp_path_factory.mktemp("jax")), batching=False,
                  prefix_cache_bytes=0, server_side_generation=request.param).start()
    try:
        info = route.loop.run(route.servers[0].handler.rpc_info({}, None))
        return request.param, _streams(model_path, route), info
    finally:
        route.stop()


def test_streams_equal_a_petals_tpu_no_batching_server(model_path, tmp_path, expected):
    server_gen, want, jax_info = expected
    route = Route(model_path, [("port", 0, N_LAYERS)], str(tmp_path), batching=False,
                  prefix_cache_bytes=0, server_side_generation=server_gen).start()
    try:
        server = route.servers[0]
        assert server.batcher is None and server.handler.batcher is None
        info = route.loop.run(server.handler.rpc_info({}, None))
        for key in ("continuous_batching", "pool"):
            assert info.get(key) is None and jax_info.get(key) is None
        got = _streams(model_path, route)
        # every session ran on a private cache, and none is left
        assert server.memory_cache.bytes_left == server.memory_cache.max_size_bytes
    finally:
        route.stop()
    for name in ("greedy", "sampled"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)
