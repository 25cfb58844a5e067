"""The stateless forward of a port server (CPU, float32) against petals_tpu's.

- ``ptu.forward`` of a port server equals a petals_tpu server's on the same
  checkpoint and the same seeded inputs, with and without deep prompts,
  over the whole span and a sub-span (rtol 1e-5, atol 1e-5).
- Over a mixed chain (a petals_tpu server on the first half, a port server
  the DHT places on the second), a petals_tpu client's
  ``RemoteSequential.forward`` and ``DistributedModelForCausalLM.forward``
  equal their outputs over two petals_tpu servers; the port's client gives
  the JAX client's logits over the same chain, and splits a batch of more
  than ``MAX_TOKENS_IN_BATCH`` tokens as the JAX client does.
- An ``active_adapter`` is refused as the inference open refuses it, and a
  malformed hidden with petals_tpu's text; a forward that outlives
  ``request_timeout`` times out, and the next one is served.

Every wait is bounded."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxModel
from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.client import sequential_autograd
from petals_tpu_torch.client.model import AutoDistributedModelForCausalLM as PortModel
from petals_tpu_torch.server.server import Server, default_dht_prefix
from petals_tpu_torch.utils.tracing import get_tracer
from tests.test_torch_swarm import Loop, Swarm
from tests.utils import make_tiny_llama

N_LAYERS = 4
RTOL = ATOL = 1e-5

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def _uids(model_path, lo, hi):
    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(lo, hi))


class Pair:
    """A port server and a petals_tpu server on every block of one
    checkpoint, each a swarm of one, on a loop thread, with a client each."""

    def __init__(self, model_path, **port_kwargs):
        self.loop = Loop()

        async def boot():
            self.port = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu",
                               compute_dtype=torch.float32, throughput=1.0, **port_kwargs)
            await self.port.start()
            self.jax = JaxServer(model_path, first_block=0, num_blocks=N_LAYERS, compute_dtype=jnp.float32,
                                 use_flash=False, throughput=1.0)
            await self.jax.start()
            self.port_client = await RpcClient.connect(self.port.host, self.port.rpc_server.port)
            self.jax_client = await RpcClient.connect(self.jax.rpc_server.host, self.jax.rpc_server.port)

        self.loop.run(boot())

    def forward(self, which, payload):
        client = self.port_client if which == "port" else self.jax_client
        return self.loop.run(client.call("ptu.forward", payload, timeout=120))

    def close(self):
        async def down():
            await self.port_client.close()
            await self.jax_client.close()
            await self.port.shutdown()
            await self.jax.shutdown()

        self.loop.run(down())
        self.loop.close()


@pytest.fixture(scope="module")
def pair(model_path):
    p = Pair(model_path)
    yield p
    p.close()


@pytest.mark.parametrize("with_prompts", [False, True], ids=["plain", "prompts"])
@pytest.mark.parametrize("span", [(0, N_LAYERS), (1, 3)], ids=["whole", "sub"])
def test_rpc_forward_equals_petals_tpu(pair, model_path, span, with_prompts):
    lo, hi = span
    hsz = pair.port.cfg.hidden_size
    rng = np.random.RandomState(5)
    hidden = (rng.standard_normal((2, 11, hsz)) * 0.1).astype(np.float32)
    tensors = {"hidden": serialize_array(hidden)}
    if with_prompts:
        prompts = (rng.standard_normal((hi - lo, 2, 3, hsz)) * 0.1).astype(np.float32)
        tensors["prompts"] = serialize_array(prompts)
    payload = {"uids": _uids(model_path, lo, hi), "tensors": tensors}
    port_out = deserialize_array(pair.forward("port", payload)["tensors"]["hidden"])
    jax_out = deserialize_array(pair.forward("jax", payload)["tensors"]["hidden"])
    assert port_out.shape == hidden.shape and port_out.dtype == np.float32
    np.testing.assert_allclose(port_out, jax_out, rtol=RTOL, atol=ATOL)


def test_forward_refusals_match_petals_tpu(pair, model_path):
    hsz = pair.port.cfg.hidden_size
    uids = _uids(model_path, 0, N_LAYERS)
    bad = {"uids": uids, "tensors": {"hidden": serialize_array(np.zeros((1, 3, hsz + 1), np.float32))}}
    texts = []
    for which in ("port", "jax"):
        with pytest.raises(Exception) as err:
            pair.forward(which, bad)
        texts.append(str(err.value))
    want = f"rpc_forward expects a [batch, seq, hidden={hsz}] tensor, got (1, 3, {hsz + 1})"
    assert all(want in t for t in texts), texts
    adapter = {"uids": uids, "tensors": {"hidden": serialize_array(np.zeros((1, 3, hsz), np.float32))},
               "active_adapter": "lora-x"}
    with pytest.raises(Exception, match="adapters are not supported by this server yet"):
        pair.forward("port", adapter)

    async def open_with_adapter():
        stream = await pair.port_client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": 16, "batch_size": 1, "active_adapter": "lora-x"})
        return await stream.recv(timeout=30)

    with pytest.raises(Exception, match="adapters are not supported by this server yet"):
        pair.loop.run(open_with_adapter())


def test_request_timeout_fires_and_next_request_is_served(pair, model_path):
    hsz = pair.port.cfg.hidden_size
    rng = np.random.RandomState(9)
    hidden = (rng.standard_normal((1, 64, hsz)) * 0.1).astype(np.float32)
    payload = {"uids": _uids(model_path, 0, N_LAYERS), "tensors": {"hidden": serialize_array(hidden)}}
    handler = pair.port.handler
    assert handler.request_timeout == 180.0  # the CLI's and petals_tpu's default
    handler.request_timeout = 1e-6
    try:
        with pytest.raises(Exception, match="Timeout"):
            pair.forward("port", payload)
    finally:
        handler.request_timeout = 180.0
    # the timed-out step still ran on the compute thread; this one waits
    # behind it and is served
    port_out = deserialize_array(pair.forward("port", payload)["tensors"]["hidden"])
    jax_out = deserialize_array(pair.forward("jax", payload)["tensors"]["hidden"])
    np.testing.assert_allclose(port_out, jax_out, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- over a swarm


@pytest.fixture(scope="module")
def swarms(model_path, tmp_path_factory):
    jax_swarm = Swarm(model_path, ("jax", "jax"), str(tmp_path_factory.mktemp("cache"))).start()
    mixed = Swarm(model_path, ("jax", "port"), str(tmp_path_factory.mktemp("cache"))).start()
    yield jax_swarm, mixed
    mixed.stop()
    jax_swarm.stop()


def _ids():
    return np.random.RandomState(13).randint(0, 100, (2, 9)).astype(np.int64)


def test_jax_client_forward_over_mixed_chain_equals_all_jax(swarms, model_path):
    jax_swarm, mixed = swarms
    hsz = mixed.port_server.cfg.hidden_size
    hidden = (np.random.RandomState(17).standard_normal((2, 7, hsz)) * 0.1).astype(np.float32)
    outs = {}
    served = get_tracer().summary().get("rpc_forward", {}).get("count", 0)
    for name, swarm in (("jax", jax_swarm), ("mixed", mixed)):
        model = JaxModel.from_pretrained(model_path, initial_peers=swarm.initial_peers)
        try:
            outs[name] = (np.asarray(model.remote.forward(hidden)), np.asarray(model.forward(_ids())))
        finally:
            model.close()
    np.testing.assert_allclose(outs["mixed"][0], outs["jax"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs["mixed"][1], outs["jax"][1], rtol=RTOL, atol=ATOL)
    # the mixed chain's forwards went through the port server (its spans)
    assert get_tracer().summary()["rpc_forward"]["count"] == served + 2


def test_port_client_forward_equals_jax_client(swarms, model_path):
    _, mixed = swarms
    jax_model = JaxModel.from_pretrained(model_path, initial_peers=mixed.initial_peers)
    port_model = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu")
    try:
        want = np.asarray(jax_model.forward(_ids()))
        got = port_model.forward(_ids())
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    finally:
        port_model.close()
        jax_model.close()


def test_batch_over_max_tokens_splits_and_joins(swarms, model_path):
    _, mixed = swarms
    hsz = mixed.port_server.cfg.hidden_size
    seq = 400  # 3 rows of 400 tokens: 1200 > MAX_TOKENS_IN_BATCH
    hidden = (np.random.RandomState(19).standard_normal((3, seq, hsz)) * 0.1).astype(np.float32)
    parts = sequential_autograd._split_batch(torch.from_numpy(hidden))
    assert [p.shape[0] for p in parts] == [2, 1]
    assert sequential_autograd.MAX_TOKENS_IN_BATCH == 1024
    jax_model = JaxModel.from_pretrained(model_path, initial_peers=mixed.initial_peers)
    port_model = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu")
    try:
        want = np.asarray(jax_model.remote.forward(hidden))
        out, histories, spans = port_model.remote.forward_with_state(hidden)
        assert len(histories) == len(spans) == 2  # one per sub-batch
        np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port_model.remote.forward(hidden).numpy(), want, rtol=RTOL, atol=ATOL)
    finally:
        port_model.close()
        jax_model.close()


def test_cli_takes_the_new_flags(model_path, tmp_path):
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    args = build_parser().parse_args([model_path, "--first_block", "0", "--device", "cpu"])
    assert (args.request_timeout, args.metrics_port, args.trace_dir) == (180.0, None, None)  # petals_tpu's
    server = build_server(build_parser().parse_args([
        model_path, "--first_block", "0", "--device", "cpu", "--request_timeout", "7", "--metrics_port", "0",
        "--trace_dir", str(tmp_path),
    ]))
    assert (server.request_timeout, server.metrics_port, server.trace_dir) == (7.0, 0, str(tmp_path))
