"""The port's client against petals_tpu's client over petals_tpu servers
only, on the CPU:

- two petals_tpu Servers on tiny-llama's halves: every case of
  tests/test_torch_client.py, array for array (a chain of two spans: no
  server-side generation path for either client);
- one full-span petals_tpu Server: greedy tokens only. There petals_tpu's
  client takes its server-side generation path (the port's waits for A5),
  whose greedy tokens are the per-token loop's; its seeded streams differ by
  design, so they are not compared."""

import numpy as np
import pytest

from tests.test_torch_client import CASES, N_LAYERS, Route, _ids, assert_same_streams, both_clients, hf_greedy
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


def test_greedy_over_one_full_span_petals_tpu_server(model_path, tmp_path_factory, monkeypatch):
    from petals_tpu.client.remote_sequential import SyncInferenceSession

    served = []
    original = SyncInferenceSession.generate_remote

    def spy(self, *args, **kwargs):
        tokens = original(self, *args, **kwargs)
        served.append(tokens is not None)
        return tokens

    monkeypatch.setattr(SyncInferenceSession, "generate_remote", spy)
    route = Route(model_path, [("jax", 0, N_LAYERS)], str(tmp_path_factory.mktemp("cache"))).start()
    try:
        jax_model, port_model = both_clients(model_path, route.initial_peers)
        try:
            ids = _ids(1, (1, 6))
            want = jax_model.generate(ids, max_new_tokens=8)
            assert served and all(served)  # petals_tpu's client took its fast path
            got = port_model.generate(ids, max_new_tokens=8)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, hf_greedy(model_path, ids, 8))
        finally:
            port_model.close()
            jax_model.close()
    finally:
        route.stop()
