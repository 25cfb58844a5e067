"""A port Server on the CPU (f32, page_size 16, 2 lanes, a 16-token prefill
budget), driven over ``ptu.inference`` by the JAX package's RpcClient: the
wire is petals_tpu's, byte for byte.

- Two concurrent sessions, a 96-token prefill and a decoding session (the
  scenario of tests/test_mixed_batching.py
  test_mixed_prefill_interleaves_with_decode): every reply equals a
  petals_tpu TransformerBackend.inference_step on the same weights, and the
  batcher's stats show the prefill rode mixed steps.
- Sessions this server does not serve yet (adapters) and malformed KV
  imports get a clear error, a step's push_to to an unreachable peer is
  served as usual, and so does server-side generation outside a
  whole-model session (tests/test_torch_server_gen.py serves it); batch > 1
  and sub-span sessions are served from private caches
  (tests/test_torch_dense.py).
- The CLI builds the server with petals_tpu's pool-sizing defaults.
- Greedy generation of 8 tokens, with the embeddings, final norm and head
  applied in the test from the checkpoint, is token-identical to the same
  loop against a petals_tpu Server.

Tolerance: atol 2e-5 in f32, as tests/test_mixed_batching.py uses."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from safetensors.numpy import load_file

from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.server.server import Server, default_dht_prefix
from tests.utils import make_tiny_llama

TOL = 2e-5
N_LAYERS = 2


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


async def _start_port_server(model_path):
    import torch

    server = Server(
        model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
        batch_lanes=2, batch_max_length=128, page_size=16, prefill_token_budget=16, throughput=1.0,
    )
    await server.start()
    client = await RpcClient.connect(server.host, server.rpc_server.port)
    return server, client


def _started(server):
    """``server`` after one start and shutdown: ``start()`` loads its span."""

    async def cycle():
        await server.start()
        await server.shutdown()

    asyncio.run(cycle())
    return server


def _uids(model_path):
    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(N_LAYERS))


def _reference_backend(model_path):
    family, cfg = jax_block_config(model_path)
    per_block = [jax_load_block(model_path, i, dtype=jnp.float32, family=family, cfg=cfg) for i in range(N_LAYERS)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block)
    return JaxBackend(
        family, cfg, stacked, first_block=0, n_blocks=N_LAYERS,
        memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
    ), cfg


def test_concurrent_prefill_and_decode_match_jax(model_path):
    async def main():
        server, client = await _start_port_server(model_path)
        try:
            hsz = server.cfg.hidden_size
            uids = _uids(model_path)
            rng = np.random.RandomState(3)
            long_prefill = rng.randn(1, 96, hsz).astype(np.float32) * 0.1
            b_prefill = rng.randn(1, 2, hsz).astype(np.float32) * 0.1
            b_steps = [rng.randn(1, 1, hsz).astype(np.float32) * 0.1 for _ in range(40)]

            stream_b = await client.open_stream("ptu.inference")
            await stream_b.send({"uids": uids, "max_length": 128, "batch_size": 1})
            assert (await stream_b.recv(timeout=60))["session_open"]
            await stream_b.send({"tensors": {"hidden": serialize_array(b_prefill)}})
            await stream_b.recv(timeout=60)

            stream_a = await client.open_stream("ptu.inference")
            await stream_a.send({"uids": uids, "max_length": 128, "batch_size": 1})
            await stream_a.recv(timeout=60)
            done = {}

            async def run_a():
                await stream_a.send({"tensors": {"hidden": serialize_array(long_prefill)}})
                reply = await stream_a.recv(timeout=120)
                done["a"] = True
                return deserialize_array(reply["tensors"]["hidden"])

            async def run_b():
                await asyncio.sleep(0.02)  # let A's prefill start
                outs = []
                while "a" not in done and len(outs) < len(b_steps):
                    await stream_b.send({"tensors": {"hidden": serialize_array(b_steps[len(outs)])}})
                    reply = await stream_b.recv(timeout=120)
                    assert reply["position"] == 2 + len(outs) + 1
                    outs.append(deserialize_array(reply["tensors"]["hidden"]))
                return outs

            out_a, outs_b = await asyncio.gather(run_a(), run_b())
            await stream_a.end()
            await stream_b.end()
            stats = dict(server.batcher.stats)
            info = await client.call("ptu.info", {}, timeout=10)
            assert info["continuous_batching"]["mixed_steps"] == stats["mixed_steps"]
        finally:
            await client.close()
            await server.shutdown()
        return out_a, outs_b, stats, long_prefill, b_prefill, b_steps

    out_a, outs_b, stats, long_prefill, b_prefill, b_steps = asyncio.run(main())
    assert stats["mixed_steps"] >= 96 // 16, stats
    assert stats["prefill_tokens"] == 96 + 2, stats
    assert stats["max_prefill_tokens_per_step"] <= 16, stats
    assert out_a.dtype == np.float32 and out_a.shape == (1, 96, long_prefill.shape[2])

    backend, _ = _reference_backend(model_path)
    kd, vd = backend.cache_descriptors(1, 128, 0, N_LAYERS)
    kv = (kd.make_zeros(), vd.make_zeros())
    want_a, _ = backend.inference_step(long_prefill, kv, 0)
    np.testing.assert_allclose(out_a, np.asarray(want_a), atol=TOL, rtol=0)
    kv = (kd.make_zeros(), vd.make_zeros())
    _, kv = backend.inference_step(b_prefill, kv, 0)
    for i, got in enumerate(outs_b):
        want, kv = backend.inference_step(b_steps[i], kv, 2 + i)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_unsupported_steps_get_a_clear_error(model_path):
    """An adapter the server does not host is refused by name, a KV import without its
    tensors with petals_tpu's error, and a push_to naming no reachable peer
    does not hold the step's reply back,
    and server-side generation outside a whole-model session (a sub-span)
    or with a malformed ``gen_sampling`` with petals_tpu's errors, never
    silently mishandled; sessions the lane pool cannot hold (batch 2, a
    sub-span) open on private caches instead."""
    from petals_tpu.rpc.client import RpcError

    async def expect_refusal(client, open_msg, step=None, match="not supported by this server yet"):
        stream = await client.open_stream("ptu.inference")
        await stream.send(open_msg)
        if step is not None:
            await stream.recv(timeout=60)
            await stream.send(step)
        with pytest.raises(RpcError, match=match):
            await stream.recv(timeout=60)

    async def main():
        server, client = await _start_port_server(model_path)
        try:
            uids = _uids(model_path)
            hidden = serialize_array(np.zeros((1, 2, server.cfg.hidden_size), np.float32))
            good = {"uids": uids, "max_length": 64, "batch_size": 1}
            sub_span = {**good, "uids": uids.split(" ")[0]}
            await expect_refusal(client, sub_span, {"tensors": {"hidden": hidden}, "gen_tokens": 4},
                                 match="server-side generation is not available for this session")
            await expect_refusal(client, good, {"tensors": {"hidden": hidden}, "gen_tokens": 4,
                                                "gen_sampling": {"do_sample": True, "top_k": -1}},
                                 match="gen_sampling.top_k must be >= 0")
            await expect_refusal(client, good, {"kv_import": {"position": 3}, "tensors": {}},
                                 match="kv_import needs k and v tensors")
            stream = await client.open_stream("ptu.inference")
            await stream.send(good)
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": hidden}, "push_to": {"addr": "x", "session_id": "y"}})
            assert (await stream.recv(timeout=60))["position"] == 2
            await stream.end()
            await expect_refusal(client, {**good, "active_adapter": "lora"},
                                 match="Adapter 'lora' is not loaded on this server")
            for open_msg in ({**good, "batch_size": 2}, {**good, "uids": _uids(model_path).split(" ")[0]}):
                stream = await client.open_stream("ptu.inference")
                await stream.send(open_msg)
                assert (await stream.recv(timeout=60))["session_open"]
                await stream.end()
            await asyncio.sleep(0.1)
            assert server.memory_cache.bytes_left == server.memory_cache.max_size_bytes - sum(
                d.nbytes for d in server.backend.paged_cache_descriptors(
                    server.batcher.n_pages, server.batcher.page_size, 0, N_LAYERS))
            # the lanes of the refused sessions came back
            assert sorted(server.batcher._free_lanes) == [0, 1]
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(main())


def test_cli_builds_the_server_with_petals_tpu_defaults(model_path, tmp_path, monkeypatch):
    """The CLI's defaults size the pool as petals_tpu's do: an 8192-token
    KV budget, lanes of min(inference_max_length, 1024) tokens, at most
    half the budget in lanes."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    args = build_parser().parse_args(
        [model_path, "--first_block", "0", "--num_blocks", "2", "--device", "cpu", "--dtype", "float32"]
    )
    monkeypatch.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path))  # the measured throughput's cache
    server = _started(build_server(args))
    # 2 blocks x 2 kv heads x head_dim 16 x f32, k and v: 512 bytes a token
    assert server.backend.cache_bytes_per_token() == 512
    assert server.memory_cache.max_size_bytes == 8192 * 512
    assert (server.batcher.n_lanes, server.batcher.max_length, server.batcher.page_size) == (4, 1024, 64)
    assert server.batcher.prefill_token_budget == 512
    # the span is optional: without it the server is placed by the swarm
    # when it starts, and sized to the device (where torch reports no device
    # memory, as on the CPU, the whole model)
    args = build_parser().parse_args([model_path, "--device", "cpu", "--dtype", "float32"])
    assert (args.first_block, args.num_blocks, args.throughput) == (None, None, "auto")
    unplaced = build_server(args)
    assert (unplaced.first_block, unplaced.num_blocks, unplaced.backend) == (None, N_LAYERS, None)
    assert unplaced.memory_cache.max_size_bytes == 8192 * 512


def _rms(x, w, eps):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * w


async def _greedy(client, uids, head, prompt, n_new):
    """Greedy loop over raw ptu.inference steps; embeddings, final norm and
    LM head applied here from the checkpoint's own tensors."""
    embed, norm_w, lm_head, eps = head
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": 64, "batch_size": 1})
    await stream.recv(timeout=60)
    tokens = list(prompt)
    hidden = embed[np.asarray(tokens)][None]
    for _ in range(n_new):
        await stream.send({"tensors": {"hidden": serialize_array(hidden.astype(np.float32))}})
        out = deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"])
        logits = _rms(out[0, -1].astype(np.float32), norm_w, eps) @ lm_head.T
        tokens.append(int(np.argmax(logits)))
        hidden = embed[tokens[-1:]][None]
    await stream.end()
    return tokens[len(prompt):]


def test_greedy_tokens_match_jax_server(model_path):
    import os

    weights = load_file(os.path.join(model_path, "model.safetensors"))
    _, cfg = jax_block_config(model_path)
    head = (weights["model.embed_tokens.weight"], weights["model.norm.weight"], weights["lm_head.weight"], cfg.rms_norm_eps)
    prompt = [3, 17, 42, 5, 99]
    uids = _uids(model_path)

    async def main():
        server, client = await _start_port_server(model_path)
        try:
            port_tokens = await _greedy(client, uids, head, prompt, 8)
        finally:
            await client.close()
            await server.shutdown()
        jserver = JaxServer(
            model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
            batching=True, batch_lanes=2, batch_max_length=128, page_size=16,
            prefix_cache_bytes=0, prefix_device_bytes=0, server_side_generation=False,
        )
        await jserver.start()
        jclient = await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)
        try:
            jax_tokens = await _greedy(jclient, uids, head, prompt, 8)
        finally:
            await jclient.close()
            await jserver.shutdown()
        return port_tokens, jax_tokens

    port_tokens, jax_tokens = asyncio.run(main())
    assert len(port_tokens) == 8
    assert port_tokens == jax_tokens


@pytest.mark.parametrize("quant_type", ["nf4a", "int8"])
def test_quantized_greedy_tokens_match_jax_server(model_path, quant_type):
    """A port server with quantized weights (fused leaves, quantized on
    load) emits the same greedy tokens as a petals_tpu server with the same
    --quant_type; ptu.info reports the kind."""
    import os

    import torch

    weights = load_file(os.path.join(model_path, "model.safetensors"))
    _, cfg = jax_block_config(model_path)
    head = (weights["model.embed_tokens.weight"], weights["model.norm.weight"], weights["lm_head.weight"], cfg.rms_norm_eps)
    prompt = [3, 17, 42, 5, 99]
    uids = _uids(model_path)

    async def main():
        server = Server(
            model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
            batch_lanes=2, batch_max_length=128, page_size=16, prefill_token_budget=16, quant_type=quant_type,
            throughput=1.0,
        )
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            info = await client.call("ptu.info", {}, timeout=10)
            port_tokens = await _greedy(client, uids, head, prompt, 8)
        finally:
            await client.close()
            await server.shutdown()
        jserver = JaxServer(
            model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
            batching=True, batch_lanes=2, batch_max_length=128, page_size=16,
            prefix_cache_bytes=0, prefix_device_bytes=0, server_side_generation=False,
            quant_type=quant_type, quant_weight_cache=False,
        )
        await jserver.start()
        jclient = await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)
        try:
            jax_tokens = await _greedy(jclient, uids, head, prompt, 8)
        finally:
            await jclient.close()
            await jserver.shutdown()
        return info, port_tokens, jax_tokens, server

    info, port_tokens, jax_tokens, server = asyncio.run(main())
    assert info["quant_type"] == quant_type
    assert sorted(server.backend.block_params[0]) == ["ln1", "ln2", "wd", "wgu", "wo", "wqkv"]
    assert all(type(server.backend.block_params[0][k]).__name__ == "QuantizedLinear" for k in ("wqkv", "wgu", "wo", "wd"))
    assert len(port_tokens) == 8
    assert port_tokens == jax_tokens


def test_cli_passes_quant_type_through(model_path, tmp_path, monkeypatch):
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    base = [model_path, "--first_block", "0", "--num_blocks", "2", "--device", "cpu", "--dtype", "float32"]
    assert build_parser().parse_args(base).quant_type == "none"
    monkeypatch.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path))  # the measured throughput's cache
    server = _started(build_server(build_parser().parse_args(base + ["--quant_type", "int4+o"])))
    assert server.quant_type == server.backend.quant_type == "int4+o"
    assert server.backend.block_params[1]["wgu"].kind == "int4+o"
    with pytest.raises(SystemExit):  # the JAX CLI's choices only
        build_parser().parse_args(base + ["--quant_type", "fp8"])


def test_client_version_is_checked_at_open_as_petals_tpu_does(model_path):
    """A JAX RpcClient opening with a compatible client_version is served by
    both servers; one opening with 9.9.0 is refused by both, with the same
    error text up to the package name."""
    import petals_tpu
    import petals_tpu_torch
    from petals_tpu.rpc.client import RpcError
    from petals_tpu.utils.version import parse_version

    assert parse_version(petals_tpu_torch.__version__) == parse_version(petals_tpu.__version__)
    compatible = petals_tpu.__version__.rsplit(".", 1)[0] + ".7"
    uids = _uids(model_path)

    async def opens(client):
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": 32, "batch_size": 1, "client_version": compatible})
        reply = await stream.recv(timeout=60)
        await stream.end()
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": 32, "batch_size": 1, "client_version": "9.9.0"})
        with pytest.raises(RpcError) as refused:
            await stream.recv(timeout=60)
        return reply, str(refused.value)

    async def main():
        server, client = await _start_port_server(model_path)
        try:
            port = await opens(client)
        finally:
            await client.close()
            await server.shutdown()
        jserver = JaxServer(
            model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
            batching=True, batch_lanes=2, batch_max_length=128, page_size=16,
            prefix_cache_bytes=0, prefix_device_bytes=0, server_side_generation=False,
        )
        await jserver.start()
        jclient = await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)
        try:
            jax = await opens(jclient)
        finally:
            await jclient.close()
            await jserver.shutdown()
        return port, jax

    (port_reply, port_error), (jax_reply, jax_error) = asyncio.run(main())
    assert port_reply["session_open"] and jax_reply["session_open"]
    assert "9.9.0" in port_error and "interoperate" in port_error
    assert port_error.replace("petals_tpu_torch", "petals_tpu") == jax_error
