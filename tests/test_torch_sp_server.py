"""A port ``Server(num_sp_devices=2, device="cpu")`` (two sp ranks in one
process) through the port's client and the wire, against petals_tpu's
sequence-parallel server and HF, on tiny-llama in float32.

- Greedy tokens: the port's client over the sp server equals a JAX client
  over a petals_tpu ``Server(num_sp_devices=2)`` and ``_hf_greedy``, for an
  8-token prompt (a query-sharded prefill) and a 7-token one (padded to 8
  rows: the sp path with ``n_valid`` masking), as
  tests/test_tensor_parallel.py's ``test_sp_session_prefill_token_identical``
  holds petals_tpu's.
- Forward and backward over the wire: ``ptu.forward`` / ``ptu.backward`` of
  8 rows (the ring) equal the JAX sp server's at 2e-4, the reference's SP
  tolerance, and the ring served them.
- KV moves byte for byte: a session exported by the sp server and imported
  into an unsharded port server exports the same bytes there, and back.
- A mixed chain, the port sp server on blocks [0, 2) and a petals_tpu
  server on [2, 4), gives the JAX client the all-JAX stream.
- A fused quantized span at sp alone fails at load with the JAX package's
  KeyError.
"""

import numpy as np
import pytest
import torch

from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from petals_tpu_torch.ops import ring_attention
from petals_tpu_torch.parallel.tp import ShardedCache
from tests.test_full_model import _hf_greedy
from tests.test_torch_client import Route
from tests.test_torch_kv_transfer import _open, _step, _uids
from tests.utils import make_tiny_llama

N_LAYERS, HALF = 4, 2
IDS = np.random.RandomState(1).randint(1, 100, (1, 8)).astype(np.int64)
IDS7 = np.random.RandomState(2).randint(1, 100, (1, 7)).astype(np.int64)
N_NEW = 6
SP_TOL = 2e-4

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def jax_route(model_path, tmp_path_factory):
    route = Route(model_path, [("jax", 0, N_LAYERS, dict(num_sp_devices=2))], str(tmp_path_factory.mktemp("j"))).start()
    yield route
    route.stop()


@pytest.fixture(scope="module")
def jax_streams(model_path, jax_route):
    """A JAX client's greedy streams over a petals_tpu sp=2 server."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    model = JaxClient.from_pretrained(model_path, initial_peers=jax_route.initial_peers)
    try:
        return [model.generate(ids, max_new_tokens=N_NEW) for ids in (IDS, IDS7)]
    finally:
        model.close()


@pytest.fixture(scope="module")
def sp_route(model_path, tmp_path_factory):
    route = Route(model_path, [("port", 0, N_LAYERS, dict(num_sp_devices=2))],
                  str(tmp_path_factory.mktemp("p"))).start()
    yield route
    route.stop()


def test_greedy_tokens_match_jax_sp_server_and_hf(model_path, sp_route, jax_streams, monkeypatch):
    from petals_tpu_torch.parallel import sp

    sharded = []
    real = sp.attend_maybe_ring

    def spy(q, k, v, *, kv, **kwargs):
        sharded.append(kv is not None and len(q) > 1)
        return real(q, k, v, kv=kv, **kwargs)

    monkeypatch.setattr(sp, "attend_maybe_ring", spy)
    (server,) = sp_route.servers
    backend = server.backend
    assert (backend.tp_size, backend.sp_size) == (1, 2) and [str(d) for d in server.mesh_devices] == ["cpu", "cpu"]
    assert server.batcher.page_size is None  # any mesh: the dense lane pool
    model = AutoDistributedModelForCausalLM.from_pretrained(model_path, initial_peers=sp_route.initial_peers,
                                                            device="cpu")
    try:
        for ids, want in zip((IDS, IDS7), jax_streams):
            with model.inference_session(max_length=32):
                ours = model.generate(ids, max_new_tokens=N_NEW)
            np.testing.assert_array_equal(ours, want)
            np.testing.assert_array_equal(ours, _hf_greedy(model_path, ids, N_NEW))
        # the per-token path (a pass-through logits processor) steps the
        # dense pool's batched decode after a query-sharded prefill
        steps = server.batcher.stats["decode_steps"]
        per_token = model.generate(IDS, max_new_tokens=N_NEW, logits_processor=[lambda ids, scores: scores])
        np.testing.assert_array_equal(per_token, jax_streams[0])
        assert server.batcher.stats["decode_steps"] > steps
        assert any(sharded) and not all(sharded)  # query-sharded prefills, tp-only decode steps
    finally:
        model.close()
    k_pool, _ = server.batcher._buffers()
    assert isinstance(k_pool, ShardedCache) and len(k_pool.ranks) == 2 and len(k_pool.distinct()) == 1
    assert backend.step_program_stats() == {"graph_captures": 0, "graph_replays": 0, "graph_anomalies": 0}


def test_forward_and_backward_over_the_wire_equal_jax_sp(model_path, sp_route, jax_route):
    from petals_tpu.rpc import RpcClient

    hsz = sp_route.servers[0].cfg.hidden_size
    rng = np.random.RandomState(3)
    hidden = (rng.standard_normal((2, 8, hsz)) * 0.3).astype(np.float32)
    grad = (rng.standard_normal((2, 8, hsz)) * 0.3).astype(np.float32)
    fwd = {"uids": _uids(model_path), "tensors": {"hidden": serialize_array(hidden)}}
    bwd = {"uids": _uids(model_path), "tensors": {"hidden": serialize_array(hidden), "grad_out": serialize_array(grad)}}

    def call(route, method, payload):
        server = route.servers[0]

        async def run():
            client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
            try:
                return await client.call(method, payload, timeout=120)
            finally:
                await client.close()

        return route.loop.run(run())

    ring_attention.reset_fold_count()
    got = [np.asarray(deserialize_array(call(sp_route, "ptu.forward", fwd)["tensors"]["hidden"])),
           np.asarray(deserialize_array(call(sp_route, "ptu.backward", bwd)["tensors"]["grad_hidden"]))]
    assert ring_attention.fold_count() > 0  # the ring served them
    want = [np.asarray(deserialize_array(call(jax_route, "ptu.forward", fwd)["tensors"]["hidden"])),
            np.asarray(deserialize_array(call(jax_route, "ptu.backward", bwd)["tensors"]["grad_hidden"]))]
    for what, g, w in zip(("forward", "backward"), got, want):
        np.testing.assert_allclose(g, w, atol=SP_TOL, rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def pair(model_path, tmp_path_factory):
    """A port sp=2 server and an unsharded port server, each on the whole
    span with no server-side generation."""
    route = Route(model_path, [("port", 0, N_LAYERS, dict(num_sp_devices=2)), ("port", 0, N_LAYERS)],
                  str(tmp_path_factory.mktemp("pair")), server_side_generation=False, prefix_cache_bytes=0).start()
    from petals_tpu.rpc import RpcClient

    clients = [route.loop.run(RpcClient.connect(s.host, s.rpc_server.port)) for s in route.servers]
    yield route, clients
    for c in clients:
        route.loop.run(c.close())
    route.stop()


def _tensors(export):
    return {name: np.asarray(deserialize_array(t)) for name, t in export["tensors"].items()}


@pytest.mark.parametrize("direction", ["sp_to_plain", "plain_to_sp"])
def test_exported_kv_is_adopted_byte_for_byte(model_path, pair, direction):
    route, (sp_client, plain_client) = pair
    src, dst = (sp_client, plain_client) if direction == "sp_to_plain" else (plain_client, sp_client)
    uids = _uids(model_path)
    hidden_size = route.servers[0].cfg.hidden_size
    rng = np.random.RandomState(7)
    prefill = rng.randn(2, 10, hidden_size).astype(np.float32) * 0.5  # 10 rows pad to 16: the sp path
    chunk = rng.randn(2, 8, hidden_size).astype(np.float32) * 0.5

    async def scenario():
        a = await _open(src, uids, f"src-{direction}", batch_size=2)
        await _step(a, prefill)
        first = await src.call("ptu.session_export", {"session_id": f"src-{direction}", "start": 0, "end": N_LAYERS})
        b = await _open(dst, uids, f"dst-{direction}", batch_size=2)
        await b.send({"kv_import": {"position": 10}, "tensors": first["tensors"]})
        assert (await b.recv(timeout=60))["kv_import"]
        again = await dst.call("ptu.session_export", {"session_id": f"dst-{direction}", "start": 0, "end": N_LAYERS})
        want, got = await _step(a, chunk), await _step(b, chunk)
        await a.end()
        await b.end()
        return first, again, want, got

    first, again, want, got = route.loop.run(scenario())
    assert first["position"] == again["position"] == 10
    for name, arr in _tensors(first).items():
        assert arr.shape == (N_LAYERS, 2, 10, 2, 16)
        np.testing.assert_array_equal(_tensors(again)[name].view(np.uint8), arr.view(np.uint8), err_msg=name)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_mixed_chain_gives_the_all_jax_stream(model_path, tmp_path, jax_streams):
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    route = Route(model_path, [("port", 0, HALF, dict(num_sp_devices=2)), ("jax", HALF, HALF)],
                  str(tmp_path)).start()
    try:
        assert route.servers[0].backend.sp_size == 2
        model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
        try:
            np.testing.assert_array_equal(model.generate(IDS, max_new_tokens=N_NEW), jax_streams[0])
        finally:
            model.close()
    finally:
        route.stop()


def test_quantized_span_at_sp_alone_fails_to_load_with_key_error(model_path):
    """The JAX server fuses a quantized span unless tp > 1 or adapters are
    set, then its split finds no spec for the fused leaf; the port keeps
    the same rule and the same error type."""
    from petals_tpu_torch.server.server import Server

    server = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", num_sp_devices=2,
                    quant_type="nf4a", compute_dtype=torch.float32, quant_weight_cache=False)
    with pytest.raises(KeyError):
        server._load_span_params(0, N_LAYERS)
    unfused = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", num_sp_devices=2,
                     quant_type="nf4a", compute_dtype=torch.float32, quant_weight_cache=False, adapters=["x"])
    assert all(len(block.ranks) == 2 for block in unfused._load_span_params(0, 1))  # adapters unfuse: it splits
