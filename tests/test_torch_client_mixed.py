"""The port's client against petals_tpu's client over the mixed chain of
tests/test_torch_swarm.py: a petals_tpu Server on 2 of tiny-llama's 4
blocks and a port Server (CPU, float32) the DHT places on the other 2, in
both orders. Neither client can take a server-side generation path here (a
chain of two spans), so every stream must be equal, array for array:
tests/test_torch_client.py's cases."""

import numpy as np
import pytest

from tests.test_torch_client import CASES, _ids, assert_same_streams, both_clients, hf_greedy
from tests.test_torch_swarm import Swarm
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=4)


@pytest.fixture(scope="module", params=[("jax", "port"), ("port", "jax")], ids=["jax_first", "port_first"])
def mixed_route(request, model_path, tmp_path_factory):
    swarm = Swarm(model_path, request.param, str(tmp_path_factory.mktemp("cache"))).start()
    jax_model, port_model = both_clients(model_path, swarm.initial_peers)
    yield swarm, jax_model, port_model
    port_model.close()
    jax_model.close()
    swarm.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_port_client_equals_jax_client_over_the_mixed_chain(mixed_route, model_path, case):
    swarm, jax_model, port_model = mixed_route
    got = assert_same_streams(jax_model, port_model, case)
    if case == "greedy":
        np.testing.assert_array_equal(got[0], hf_greedy(model_path, _ids(1, (1, 6)), 8))
    # the chain went through the port server
    assert swarm.port_server.batcher.stats["batched_steps"] > 0
