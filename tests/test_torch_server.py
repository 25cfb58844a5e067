"""A port Server on the CPU (f32, page_size 16, 2 lanes, a 16-token prefill
budget), driven over ``ptu.inference`` by the JAX package's RpcClient: the
wire is petals_tpu's, byte for byte.

- Two concurrent sessions, a 96-token prefill and a decoding session (the
  scenario of tests/test_mixed_batching.py
  test_mixed_prefill_interleaves_with_decode): every reply equals a
  petals_tpu TransformerBackend.inference_step on the same weights, and the
  batcher's stats show the prefill rode mixed steps.
- Steps and sessions this server does not serve yet (server-side
  generation, KV import, batch > 1, sub-spans) get a clear error.
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
        batch_lanes=2, batch_max_length=128, page_size=16, prefill_token_budget=16,
    )
    await server.start()
    client = await RpcClient.connect(server.host, server.rpc_server.port)
    return server, client


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
    """Server-side generation, KV import and sessions the lane pool cannot
    serve are refused as not supported yet, never silently mishandled."""
    from petals_tpu.rpc.client import RpcError

    async def expect_refusal(client, open_msg, step=None):
        stream = await client.open_stream("ptu.inference")
        await stream.send(open_msg)
        if step is not None:
            await stream.recv(timeout=60)
            await stream.send(step)
        with pytest.raises(RpcError, match="not supported by this server yet"):
            await stream.recv(timeout=60)

    async def main():
        server, client = await _start_port_server(model_path)
        try:
            uids = _uids(model_path)
            hidden = serialize_array(np.zeros((1, 2, server.cfg.hidden_size), np.float32))
            good = {"uids": uids, "max_length": 64, "batch_size": 1}
            await expect_refusal(client, good, {"tensors": {"hidden": hidden}, "gen_tokens": 4})
            await expect_refusal(client, good, {"tensors": {"hidden": hidden}, "gen_sampling": {"do_sample": True}})
            await expect_refusal(client, good, {"kv_import": {"position": 3}, "tensors": {}})
            await expect_refusal(client, {**good, "batch_size": 2})
            await expect_refusal(client, {**good, "uids": _uids(model_path).split(" ")[0]})
            # the lanes of the refused sessions came back
            assert sorted(server.batcher._free_lanes) == [0, 1]
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(main())


def test_cli_builds_the_server_with_petals_tpu_defaults(model_path):
    """The CLI's defaults size the pool as petals_tpu's do: an 8192-token
    KV budget, lanes of min(inference_max_length, 1024) tokens, at most
    half the budget in lanes."""
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    args = build_parser().parse_args(
        [model_path, "--first_block", "0", "--num_blocks", "2", "--device", "cpu", "--dtype", "float32"]
    )
    server = build_server(args)
    # 2 blocks x 2 kv heads x head_dim 16 x f32, k and v: 512 bytes a token
    assert server.backend.cache_bytes_per_token() == 512
    assert server.memory_cache.max_size_bytes == 8192 * 512
    assert (server.batcher.n_lanes, server.batcher.max_length, server.batcher.page_size) == (4, 1024, 64)
    assert server.batcher.prefill_token_budget == 512
    with pytest.raises(SystemExit):  # the span is required
        build_parser().parse_args([model_path])


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
