"""A port ``Server(num_tp_devices=2, device="cpu")`` (two CPU shards in one
process) through the port's client and the wire, against petals_tpu's TP
server and HF, on tiny-llama in float32.

- Greedy tokens: the port's client over the TP server equals a JAX client
  over a petals_tpu ``Server(num_tp_devices=2)`` and ``_hf_greedy``, and
  the server-side generation path served it (a spy on the client's
  ``_server_side_greedy``, as tests/test_tensor_parallel.py:415-452 does).
- The dense lane pool serves it: paging is off (``page_size`` None, a
  ShardedCache pool), a per-token stream steps the batched decode, and the
  scheduler does not preempt even with a swap budget.
- KV moves byte for byte: a session exported by the TP server and imported
  into an unsharded port server exports the same bytes there, and the other
  way round, for a pooled (batch 1) and a private (batch 2) session; the
  next chunk's outputs agree within float32's 2e-5.
- A mixed chain, the port TP server on blocks [0, 2) and a petals_tpu
  server on [2, 4), gives the JAX client the all-JAX stream.
"""

import numpy as np
import pytest
import torch

from petals_tpu.rpc.serialization import deserialize_array
from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from petals_tpu_torch.parallel.tp import ShardedCache
from tests.test_full_model import _hf_greedy
from tests.test_torch_client import Route
from tests.test_torch_kv_transfer import _open, _step, _uids
from tests.utils import make_tiny_llama

N_LAYERS, HALF = 4, 2
IDS = np.random.RandomState(0).randint(1, 100, (1, 5)).astype(np.int64)
N_NEW = 6

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def jax_stream(model_path, tmp_path_factory):
    """A JAX client's greedy stream over a petals_tpu TP=2 server."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    route = Route(model_path, [("jax", 0, N_LAYERS, dict(num_tp_devices=2))], str(tmp_path_factory.mktemp("j"))).start()
    try:
        model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
        try:
            return model.generate(IDS, max_new_tokens=N_NEW)
        finally:
            model.close()
    finally:
        route.stop()


@pytest.fixture(scope="module")
def tp_route(model_path, tmp_path_factory):
    route = Route(model_path, [("port", 0, N_LAYERS, dict(num_tp_devices=2, swap_host_bytes=64 << 20))],
                  str(tmp_path_factory.mktemp("p"))).start()
    yield route
    route.stop()


def test_greedy_tokens_match_jax_tp_server_and_hf(model_path, tp_route, jax_stream):
    (server,) = tp_route.servers
    assert server.backend.tp_size == 2 and [str(d) for d in server.tp_devices] == ["cpu", "cpu"]
    model = AutoDistributedModelForCausalLM.from_pretrained(model_path, initial_peers=tp_route.initial_peers,
                                                            device="cpu")
    try:
        served = {"n": 0}
        orig = type(model)._server_side_greedy

        def spy(self, *a, **kw):
            out = orig(self, *a, **kw)
            if out is not None:
                served["n"] += 1
            return out

        import unittest.mock as _mock

        with _mock.patch.object(type(model), "_server_side_greedy", spy):
            ours = model.generate(IDS, max_new_tokens=N_NEW)
        assert served["n"] == 1, "the TP server's server-side generation did not serve"
        np.testing.assert_array_equal(ours, jax_stream)
        np.testing.assert_array_equal(ours, _hf_greedy(model_path, IDS, N_NEW))
        assert server.batcher.stats["gen_steps"] > 0

        # the per-token path (a pass-through logits processor) steps the
        # dense pool's batched decode
        steps = server.batcher.stats["decode_steps"]
        per_token = model.generate(IDS, max_new_tokens=N_NEW, logits_processor=[lambda ids, scores: scores])
        np.testing.assert_array_equal(per_token, jax_stream)
        assert server.batcher.stats["decode_steps"] > steps
    finally:
        model.close()


def test_dense_lane_pool_and_no_preemption(tp_route):
    (server,) = tp_route.servers
    batcher = server.batcher
    assert server.page_size == 64  # asked for, and gated off under TP
    assert batcher.page_size is None and batcher.max_pages == 0
    k_pool, v_pool = batcher._buffers()
    assert isinstance(k_pool, ShardedCache) and len(k_pool.shards) == 2
    assert k_pool.shards[0].shape[-2] * 2 == server.backend.num_kv_heads
    assert batcher.swap_pool.max_size_bytes > 0 and not batcher._can_preempt()
    assert batcher._scheduler.stats["preemptions"] == 0
    assert server.backend.step_program_stats() == {"graph_captures": 0, "graph_replays": 0, "graph_anomalies": 0}
    assert server.handler.prefix_cache is None or server.handler.prefix_cache.stats.get("device_hits", 0) == 0


@pytest.fixture(scope="module")
def pair(model_path, tmp_path_factory):
    """A port TP=2 server and an unsharded port server, each on the whole
    span with no server-side generation."""
    route = Route(model_path, [("port", 0, N_LAYERS, dict(num_tp_devices=2)), ("port", 0, N_LAYERS)],
                  str(tmp_path_factory.mktemp("pair")), server_side_generation=False, prefix_cache_bytes=0).start()
    from petals_tpu.rpc import RpcClient

    clients = [route.loop.run(RpcClient.connect(s.host, s.rpc_server.port)) for s in route.servers]
    yield route, clients
    for c in clients:
        route.loop.run(c.close())
    route.stop()


def _tensors(export):
    return {name: np.asarray(deserialize_array(t)) for name, t in export["tensors"].items()}


@pytest.mark.parametrize("direction", ["tp_to_plain", "plain_to_tp"])
@pytest.mark.parametrize("batch", [1, 2])
def test_exported_kv_is_adopted_byte_for_byte(model_path, pair, direction, batch):
    route, (tp_client, plain_client) = pair
    src, dst = (tp_client, plain_client) if direction == "tp_to_plain" else (plain_client, tp_client)
    uids = _uids(model_path)
    hidden_size = route.servers[0].cfg.hidden_size
    rng = np.random.RandomState(batch)
    prefill = rng.randn(batch, 9, hidden_size).astype(np.float32) * 0.5
    chunk = rng.randn(batch, 8, hidden_size).astype(np.float32) * 0.5
    tag = f"{direction}-{batch}"

    async def scenario():
        a = await _open(src, uids, f"src-{tag}", batch_size=batch)
        await _step(a, prefill)
        first = await src.call("ptu.session_export", {"session_id": f"src-{tag}", "start": 0, "end": N_LAYERS})
        b = await _open(dst, uids, f"dst-{tag}", batch_size=batch)
        await b.send({"kv_import": {"position": 9}, "tensors": first["tensors"]})
        assert (await b.recv(timeout=60))["kv_import"]
        again = await dst.call("ptu.session_export", {"session_id": f"dst-{tag}", "start": 0, "end": N_LAYERS})
        want, got = await _step(a, chunk), await _step(b, chunk)
        await a.end()
        await b.end()
        return first, again, want, got

    first, again, want, got = route.loop.run(scenario())
    assert first["position"] == again["position"] == 9
    for name, arr in _tensors(first).items():
        assert arr.shape == (N_LAYERS, batch, 9, 2, 16)
        np.testing.assert_array_equal(_tensors(again)[name].view(np.uint8), arr.view(np.uint8), err_msg=name)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_mixed_chain_gives_the_all_jax_stream(model_path, tmp_path, jax_stream):
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    route = Route(model_path, [("port", 0, HALF, dict(num_tp_devices=2)), ("jax", HALF, HALF)],
                  str(tmp_path)).start()
    try:
        assert route.servers[0].backend.tp_size == 2
        model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
        try:
            np.testing.assert_array_equal(model.generate(IDS, max_new_tokens=N_NEW), jax_stream)
        finally:
            model.close()
    finally:
        route.stop()
