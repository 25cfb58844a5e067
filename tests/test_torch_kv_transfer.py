"""KV that crosses between petals_tpu servers and port servers, byte for byte.

- Adopt (``ptu.session_migrate`` then ``kv_adopt``): a petals_tpu server's
  session is parked and pushed, as its drain pushes it, to a petals_tpu
  server and to a port server of the same kind; each adopts it in a fresh
  session. The two pools' pages for the adopted lane are byte-equal (codes
  and scales of a quantized pool) for a bf16 pool, an int8 pool and an
  nf4a pool (the last two in float32 compute, their entries packed on the
  wire), and both then continue with the same greedy stream (HF's embedding
  and head applied in the test). tests/test_torch_migration.py holds
  adopted float32 sessions to HF's stream.
- Export: each adopted session's ``ptu.session_export`` is the same, tensor
  by tensor (shape, type, bytes), on both servers.
- A private batch-2 session (its own dense cache) exported by a port server
  and imported into a port server and a petals_tpu server: the next 8-token
  chunk's output equals the exporting session's own (bit-equal on the port,
  within float32's 2e-5 on petals_tpu).

The page size is 16, so that the adopted 22 rows fill one page and part of
a second one. Each kind's three servers start on first use, on one loop
thread, with no swarm (the pushes dial the contact addresses)."""

import asyncio
import threading

import numpy as np
import pytest
import torch

from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.server.server import Server, default_dht_prefix
from tests.utils import make_tiny_llama

N_LAYERS = 4
PAGE = 16
MAX_LENGTH = 64
PROMPT = 20  # + 2 decoded on the source: 22 rows, a page and 6/16 of another
CONTINUE = 4

# kind -> (compute dtype name, KV pool kind)
KINDS = {"bf16": ("bfloat16", "none"), "int8": ("float32", "int8"), "nf4a": ("float32", "nf4a")}

pytestmark = pytest.mark.timeout(600)


class _Loop:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def hf(model_path):
    from transformers import AutoModelForCausalLM

    return AutoModelForCausalLM.from_pretrained(model_path, dtype=torch.float32).eval()


async def _start(kind_name, model_path, kind):
    import jax.numpy as jnp

    dtype, kvq = KINDS[kind]
    common = dict(batch_lanes=2, batch_max_length=MAX_LENGTH, page_size=PAGE, kv_quant_type=kvq, throughput=1.0,
                  server_side_generation=False, prefix_cache_bytes=0)
    if kind_name == "jax":
        server = JaxServer(model_path, compute_dtype=getattr(jnp, dtype), use_flash=False, batching=True, **common)
        await server.start()
        host, port = server.rpc_server.host, server.rpc_server.port
    else:
        server = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu",
                        compute_dtype=getattr(torch, dtype), **common)
        await server.start()
        host, port = server.host, server.rpc_server.port
    return server, await RpcClient.connect(host, port)


@pytest.fixture(scope="module")
def servers(model_path):
    """kind -> {"source": petals_tpu, "jax": petals_tpu, "port": port}:
    (server, client) pairs started on first use."""
    loop, started = _Loop(), {}

    def get(kind):
        if kind not in started:
            started[kind] = {name: loop.run(_start(cls, model_path, kind))
                             for name, cls in (("source", "jax"), ("jax", "jax"), ("port", "port"))}
        return started[kind]

    get.loop = loop
    yield get

    async def stop(server, client):
        await client.close()
        await server.shutdown()

    for trio in started.values():
        for server, client in trio.values():
            loop.run(stop(server, client))
    loop.close()


def _uids(model_path):
    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(N_LAYERS))


def _next_token(hf, out) -> int:
    with torch.no_grad():
        last = torch.as_tensor(np.asarray(out, np.float32))[:, -1]
        return int(hf.lm_head(hf.model.norm(last)).argmax(-1)[0])


def _embed(hf, ids) -> np.ndarray:
    with torch.no_grad():
        return hf.model.embed_tokens(torch.as_tensor(ids).reshape(1, -1)).numpy()


async def _open(client, uids, session_id, batch_size=1):
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": MAX_LENGTH, "batch_size": batch_size, "session_id": session_id})
    assert (await stream.recv(timeout=60))["session_open"]
    return stream


async def _step(stream, hidden):
    await stream.send({"tensors": {"hidden": serialize_array(np.asarray(hidden, np.float32))}})
    reply = await stream.recv(timeout=120)
    return np.asarray(deserialize_array(reply["tensors"]["hidden"]), np.float32)


def _lane_pages(server, n_rows):
    """The table's pages holding a lane's rows [0, n_rows): the one busy lane."""
    batcher = server.handler.batcher
    (lane,) = [l for l in range(batcher.n_lanes) if l not in batcher._free_lanes]
    return [int(p) for p in batcher._tables[lane][: -(-n_rows // PAGE)]]


def _page_bytes(server, page):
    """Every block's bytes of ``page`` in both pools (codes and scales of a
    quantized pool), as uint8 arrays."""
    if isinstance(server, JaxServer):
        import jax

        return [np.ascontiguousarray(np.asarray(leaf[:, page])).view(np.uint8)
                for leaf in jax.tree_util.tree_leaves(server.handler.batcher._buffers())]
    return [t[:, page].contiguous().view(torch.uint8).numpy()
            for pool in server.handler.batcher._buffers() for t in (pool if isinstance(pool, tuple) else (pool,))]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_adopt_of_a_jax_entry_is_byte_equal(servers, model_path, hf, kind):
    trio = servers(kind)
    (src, src_client), (jax_dst, jax_client), (port_dst, port_client) = trio["source"], trio["jax"], trio["port"]
    uids = _uids(model_path)
    ids = np.random.RandomState(5).randint(1, 100, (1, PROMPT)).astype(np.int64)

    async def scenario():
        # the source: a prefill and two greedy decode steps, then parked and
        # pushed to both destinations, as a drain pushes it
        stream = await _open(src_client, uids, f"src-{kind}")
        token = _next_token(hf, await _step(stream, _embed(hf, ids)))
        tokens = [token]
        for _ in range(2):
            token = _next_token(hf, await _step(stream, _embed(hf, [token])))
            tokens.append(token)
        assert await src.handler.park_sessions() == 1
        snap = src.handler._parked[f"src-{kind}"]
        position = snap["position"]
        assert position == PROMPT + 2
        for dst in (jax_dst, port_dst):
            assert await src.handler.migrate_parked_to(
                f"src-{kind}", snap, dst.dht.peer_id.to_string(), dst.contact_addr.to_string(),
            )
        streams = {}
        for name, client in (("jax", jax_client), ("port", port_client)):
            streams[name] = await _open(client, uids, f"dst-{kind}")
            await streams[name].send({"kv_adopt": {"session_id": f"src-{kind}", "position": position}})
            assert await streams[name].recv(timeout=60) == {"position": position, "kv_adopt": True}
        pages = {name: [_page_bytes(s, p) for p in _lane_pages(s, position)]
                 for name, s in (("jax", jax_dst), ("port", port_dst))}
        exports = {}
        for name, client in (("jax", jax_client), ("port", port_client)):
            exports[name] = await client.call("ptu.session_export",
                                              {"session_id": f"dst-{kind}", "start": 0, "end": N_LAYERS})
        continued = {}
        for name in ("jax", "port"):
            tok, stream_tokens = token, []
            for _ in range(CONTINUE):
                tok = _next_token(hf, await _step(streams[name], _embed(hf, [tok])))
                stream_tokens.append(tok)
            continued[name] = stream_tokens
            await streams[name].end()
        await stream.end()
        return tokens, pages, exports, continued

    tokens, pages, exports, continued = servers.loop.run(scenario())
    assert len(pages["jax"]) == len(pages["port"]) == 2
    for page_j, page_p in zip(pages["jax"], pages["port"]):
        assert len(page_j) == len(page_p)
        for a, b in zip(page_j, page_p):
            assert a.shape == b.shape and np.array_equal(a, b), "the adopted pages differ"
    for name in ("k", "v"):
        j, p = exports["jax"]["tensors"][name], exports["port"]["tensors"][name]
        assert (j["shape"], j["dtype"], j["data"]) == (p["shape"], p["dtype"], p["data"]), f"export {name} differs"
    assert exports["jax"]["position"] == exports["port"]["position"] == PROMPT + 2
    assert continued["jax"] == continued["port"]


def test_private_session_export_import(servers, model_path):
    """A private batch-2 session's export seeds a fresh batch-2 session on a
    port server and on a petals_tpu server: the next 8-token chunk's output
    equals the exporting session's own."""
    trio = servers("int8")
    (jax_srv, jax_client), (port_srv, port_client) = trio["jax"], trio["port"]
    uids = _uids(model_path)
    rng = np.random.RandomState(6)
    prefill = rng.randn(2, 9, port_srv.cfg.hidden_size).astype(np.float32) * 0.5
    chunk = rng.randn(2, 8, port_srv.cfg.hidden_size).astype(np.float32) * 0.5

    async def scenario():
        src = await _open(port_client, uids, "private-src", batch_size=2)
        await _step(src, prefill)
        export = await port_client.call("ptu.session_export", {"session_id": "private-src", "start": 0, "end": N_LAYERS})
        assert export["position"] == 9 and export["batch_size"] == 2
        want = await _step(src, chunk)
        got = {}
        for name, client in (("port", port_client), ("jax", jax_client)):
            dst = await _open(client, uids, f"private-dst-{name}", batch_size=2)
            await dst.send({"kv_import": {"position": 9}, "tensors": export["tensors"]})
            assert (await dst.recv(timeout=60))["kv_import"]
            got[name] = await _step(dst, chunk)
            await dst.end()
        await src.end()
        return want, got

    want, got = servers.loop.run(scenario())
    np.testing.assert_array_equal(got["port"], want)
    np.testing.assert_allclose(got["jax"], want, atol=2e-5, rtol=0)
