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
- An ``active_adapter`` the server does not host is refused as the
  inference open refuses it, and a malformed hidden, with petals_tpu's text; a forward that outlives
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
    with pytest.raises(Exception, match="Adapter 'lora-x' is not loaded on this server"):
        pair.forward("port", adapter)

    async def open_with_adapter():
        stream = await pair.port_client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": 16, "batch_size": 1, "active_adapter": "lora-x"})
        return await stream.recv(timeout=30)

    with pytest.raises(Exception, match="Adapter 'lora-x' is not loaded on this server"):
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


# ------------------------------------------------------------------ the forward's length buckets


def _tiny_phi3_short_window(root):
    """Phi-3 with LongRoPE whose original window (48) lies inside a bucket
    (64): a 40-token forward pads to 64 rows, whose last position would take
    the long factors if the padding counted as real."""
    import os

    from transformers import Phi3Config, Phi3ForCausalLM

    cfg = Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=192, original_max_position_embeddings=48, rms_norm_eps=1e-6,
        rope_scaling={"type": "longrope", "short_factor": [1.0 + 0.05 * i for i in range(8)],
                      "long_factor": [2.0 + 0.3 * i for i in range(8)]},
        tie_word_embeddings=False, pad_token_id=0,
    )
    torch.manual_seed(12)
    path = os.path.join(root, "tiny-phi3-window-48")
    Phi3ForCausalLM(cfg).eval().save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def bucket_backends(model_path, tmp_path_factory):
    from tests.test_torch_dense_programs import _backends

    phi3 = _tiny_phi3_short_window(str(tmp_path_factory.mktemp("phi3")))
    return {"llama": _backends(model_path, span=(0, N_LAYERS)), "phi3": _backends(phi3, span=(0, 2))}


# (model, lengths, deep-prompt rows): lengths of 3 to 30 fall in buckets
# 8, 16 and 32; phi3's 40 and 44 pad to 64 rows past its window of 48
BUCKET_CASES = [("llama", (3, 5, 8, 9, 12, 16, 20, 30), 0), ("llama", (6, 11, 14, 25), 4),
                ("phi3", (40, 44, 30, 52), 0)]


@pytest.mark.parametrize("name,lengths,pre_seq", BUCKET_CASES, ids=["llama", "llama-prompts", "phi3"])
def test_forward_is_bucketed_and_equals_petals_tpu(bucket_backends, name, lengths, pre_seq):
    """C12: the stateless forward pads each call to its length's bucket, so
    N distinct lengths leave at most one graph a bucket (a deep prompt's
    pre_seq stays in the key), and every reply still equals petals_tpu's
    ``forward`` at the exact length (rtol / atol 1e-5): the padded tail
    changes no real row, nor longrope's factors (phi3 at 40 and 44 rows,
    inside its window of 48 while their bucket of 64 is not)."""
    from petals_tpu_torch.server.backend import bucket_length
    from tests.test_torch_dense_programs import _counts, _stubbed

    jax_backend, backend = bucket_backends[name]
    stub, _ = _stubbed(backend)
    rng = np.random.default_rng(13)
    hsz = backend.hidden_size
    for n in lengths:
        hidden = (rng.standard_normal((2, n, hsz)) * 0.1).astype(np.float32)
        prompts = (rng.standard_normal((backend.n_blocks, 2, pre_seq, hsz)) * 0.1).astype(np.float32) \
            if pre_seq else None
        want = np.asarray(jax_backend.forward(hidden, prompts=prompts))
        for _ in range(2):  # the bucket's first call runs eagerly, its second captures (or replays)
            got = stub.forward(torch.from_numpy(hidden), prompts=None if prompts is None else torch.from_numpy(prompts))
            assert got.shape == (2, n, hsz)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL, err_msg=f"{name} forward of {n}")
    buckets = {bucket_length(n) for n in lengths}
    assert len(stub._forward_program._entries) == _counts(stub, "_forward_program")["captures"] <= len(buckets)
    assert {key[2] for key in stub._forward_program._entries} <= buckets
    assert all(key[3] == pre_seq for key in stub._forward_program._entries)
