"""The port's prefix cache (petals_tpu_torch/server/prefix_cache.py and its
handler, batcher and backend paths) held to petals_tpu's, with the cache ON
on both sides.

- ``segment_keys`` equals petals_tpu's over the same wire payloads (float32,
  and bfloat16 through its int16 view).
- The same sequences of put / probe / worth_storing / eviction / promotion
  on the port's ``RadixPrefixCache`` and on petals_tpu's (no swap pool, no
  usage function, no ledger) leave equal ``summary()``s and equal stores,
  under both policies and a device-tier budget.
- A port Server and a petals_tpu Server (tiny-llama, f32, 2 lanes of 512
  tokens) get the same traffic in four configurations: a paged pool (page
  16), the dense pool (page_size 0), a private session on a sub-span, an
  int8 pool. A shared two-segment prefix with different tails, an exact full
  match that runs nothing, and: on the paged pools a rollback into a pinned
  page (one fork, the page's bytes unchanged) and a pool reset that kills
  the pins (the hit falls back to the host tier, then the device tier after
  promotion); on the private session a host-tier hit and a device-tier hit
  after promotion. Every reply equals petals_tpu's and a port server's
  with the cache off; the stats and ``ptu.info``'s ``prefix_cache`` equal
  petals_tpu's.
- ``peer`` scope, a store cancelled mid-snapshot (every refcount back where
  it was), greedy tokens (a miss, then a hit) equal to petals_tpu's, and an
  exclusive pass over adopted pages of an int8 pool (the insert re-encodes
  them: the bytes petals_tpu's insert leaves, ROADMAP Queue C).
- The CLI's four flags and the Server's defaults are petals_tpu's, and an
  auto-sized KV budget gives up the HBM tier's bytes as petals_tpu's does.

Servers are module-scoped, on one event loop of their own. Tolerance: atol
2e-5 in f32, as tests/test_prefix_cache.py uses."""

import asyncio
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server import prefix_cache as jax_pc
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.rpc.serialization import deserialize_array as port_deserialize
from petals_tpu_torch.server import prefix_cache as port_pc
from petals_tpu_torch.server.server import Server, default_dht_prefix
from tests.utils import make_tiny_llama

TOL = 2e-5
N_LAYERS = 2
SEG = port_pc.SEGMENT_TOKENS
MAX_LENGTH = 512

# name: (page_size, kv_quant_type, the sessions' blocks)
CONFIGS = {
    "paged": (16, "none", (0, N_LAYERS)),
    "dense": (0, "none", (0, N_LAYERS)),
    "private": (16, "none", (0, 1)),  # a sub-span session: a private cache
    "int8": (16, "int8", (0, N_LAYERS)),
}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


class _Loop:
    """One event loop on a thread of its own, shared by the module's servers."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=300):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


async def _port_server(model_path, page_size, kv_quant_type, **kw):
    server = Server(
        model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
        batch_lanes=2, batch_max_length=MAX_LENGTH, page_size=page_size, kv_quant_type=kv_quant_type,
        throughput=1.0, server_side_generation=False, **kw,
    )
    await server.start()
    return server, await RpcClient.connect(server.host, server.rpc_server.port)


async def _jax_server(model_path, page_size, kv_quant_type, **kw):
    server = JaxServer(
        model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0, batching=True,
        batch_lanes=2, batch_max_length=MAX_LENGTH, page_size=page_size, kv_quant_type=kv_quant_type,
        server_side_generation=False, **kw,
    )
    await server.start()
    return server, await RpcClient.connect(server.rpc_server.host, server.rpc_server.port)


@pytest.fixture(scope="module")
def servers(model_path):
    """name -> {"port", "jax", "off"}: (server, client) pairs started on
    first use; "off" is a port server with the cache off."""
    loop, started = _Loop(), {}

    def get(name):
        ps, kvq, _ = CONFIGS[name]
        if (ps, kvq) not in started:  # the private sessions share the paged pool's servers
            started[ps, kvq] = {
                "port": loop.run(_port_server(model_path, ps, kvq)),
                "jax": loop.run(_jax_server(model_path, ps, kvq)),
                "off": loop.run(_port_server(model_path, ps, kvq, prefix_cache_bytes=0)),
            }
        return started[ps, kvq]

    get.loop = loop
    yield get

    async def stop(server, client):
        await client.close()
        await server.shutdown()

    for pair in started.values():
        for server, client in pair.values():
            loop.run(stop(server, client))
    loop.close()


def _uids(model_path, blocks):
    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(*blocks))


async def _session(client, uids, steps, max_length=MAX_LENGTH):
    """One session: ``steps`` are (hidden, extra step fields). Returns each
    reply's (hidden, variant)."""
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": max_length, "batch_size": 1})
    await stream.recv(timeout=60)
    outs = []
    for hidden, extra in steps:
        await stream.send({"tensors": {"hidden": serialize_array(hidden), **extra.get("tensors", {})},
                           **{k: v for k, v in extra.items() if k != "tensors"}})
        reply = await stream.recv(timeout=120)
        outs.append((deserialize_array(reply["tensors"]["hidden"]), reply["step_meta"]["variant"]))
    await stream.end()
    return outs


def _inputs(seed, hsz):
    rng = np.random.RandomState(seed)
    shared = rng.randn(1, 2 * SEG, hsz).astype(np.float32) * 0.1
    tail1 = rng.randn(1, 9, hsz).astype(np.float32) * 0.1
    tail2 = rng.randn(1, 5, hsz).astype(np.float32) * 0.1
    steps = [rng.randn(1, 1, hsz).astype(np.float32) * 0.1 for _ in range(3)]
    return shared, np.concatenate([shared, tail1], 1), np.concatenate([shared, tail2], 1), steps


def _pc(server):
    return server.handler.prefix_cache


async def _promoted(server, n):
    """Wait until the cache counts ``n`` promotions (they run off the reply
    path)."""
    for _ in range(500):
        if _pc(server).stats["promotions"] >= n:
            return
        await asyncio.sleep(0.01)
    raise AssertionError(_pc(server).stats)


def _page_bytes(server, page):
    """The bytes page ``page`` holds in every block of both pools (codes and
    scales of a quantized pool), on the host."""
    return [np.array(leaf[:, page]) for leaf in jax.tree_util.tree_leaves(server.handler.batcher._buffers())] \
        if isinstance(server, JaxServer) else [
            t[:, page].clone().numpy() for pool in server.handler.batcher._buffers()
            for t in (pool if isinstance(pool, tuple) else (pool,))]


def _forked(server):
    return server.handler.batcher._pages.stats["forked"]


def _reset_pool(server):
    """Reset a batcher's pool as a failed device step does."""
    if isinstance(server, JaxServer):
        for leaf in jax.tree_util.tree_leaves(server.handler.batcher._buffers()):
            leaf.delete()
        server.handler.batcher._maybe_reset_pool()
    else:
        server.handler.batcher._maybe_reset_pool(RuntimeError("a failed device step"))


async def _traffic(name, server, client, uids, hsz, probe=None):
    """The same sessions on any server; ``probe(event, server)`` is called
    between phases of a server with the cache on. Returns every session's
    replies."""
    shared, p1, p2, steps = _inputs(0, hsz)
    cached = _pc(server) is not None
    promotions = _pc(server).stats["promotions"] if cached else 0
    out = {
        "s1": await _session(client, uids, [(p1, {}), (steps[0], {})]),
        "s2": await _session(client, uids, [(p2, {}), (steps[0], {})]),
    }
    prefilled = dict(server.handler.batcher.stats)
    out["s3"] = await _session(client, uids, [(shared, {}), (steps[1], {})])
    if cached and name in ("paged", "int8") and isinstance(server, Server):
        # the exact match fed no prefill token to the pool: only its decode step ran
        assert server.handler.batcher.stats["prefill_tokens"] == prefilled["prefill_tokens"]
        assert server.handler.batcher.stats["mixed_steps"] == prefilled["mixed_steps"]
    if cached:
        probe("after_hits", server)
    if name in ("paged", "int8"):
        # roll back into the first (pinned) segment and rewrite from row 40
        out["s4"] = await _session(client, uids, [
            (p1, {}), (steps[0], {"start_from_position": 40}), (steps[1], {}),
        ])
        if cached:
            probe("after_rollback", server)
        out["s5"] = await _session(client, uids, [(shared, {}), (steps[1], {})])
        _reset_pool(server)
        # the pins died with the pool: the host tier serves, then promotes
        out["s6"] = await _session(client, uids, [(p2, {}), (steps[2], {})])
        if cached:
            probe("after_reset", server)
    if name == "private":
        # the device tier dropped: a host-tier hit, which promotes the path
        if cached:
            _pc(server)._evict_device(0)
        out["s4"] = await _session(client, uids, [(p1, {}), (steps[2], {})])
    if name != "dense":
        if cached:
            await _promoted(server, promotions + 2)
        out["s7"] = await _session(client, uids, [(p2, {}), (steps[2], {})])  # a device-tier hit
        if cached:
            probe("after_promotion", server)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_server_traffic_matches_petals_tpu(servers, model_path, name):
    pair = servers(name)
    uids = _uids(model_path, CONFIGS[name][2])
    hsz = pair["port"][0].cfg.hidden_size
    seen = {"port": {}, "jax": {}}

    base = {kind: dict(_pc(pair[kind][0]).stats) for kind in ("port", "jax")}

    def probe(kind):
        def record(event, server):
            stats = _pc(server).stats
            # the servers are shared between tests: counters since this one began
            snap = {"summary": _pc(server).summary(),
                    "delta": {k: v - base[kind].get(k, 0) for k, v in stats.items()}}
            if name in ("paged", "int8"):
                snap["forked"] = _forked(server)
                entry = _pc(server)._store[next(iter(_pc(server)._store))]
                if "pages" in entry:
                    snap["page2"] = entry["pages"][2]
                    snap["page2_bytes"] = _page_bytes(server, entry["pages"][2])
            seen[kind][event] = snap
        return record

    port = servers.loop.run(_traffic(name, pair["port"][0], pair["port"][1], uids, hsz, probe("port")))
    ref = servers.loop.run(_traffic(name, pair["jax"][0], pair["jax"][1], uids, hsz, probe("jax")))
    off = servers.loop.run(_traffic(name, pair["off"][0], pair["off"][1], uids, hsz))

    assert port.keys() == ref.keys()
    for key in port:
        # the packages name their other paths differently; a step that ran
        # nothing is "cached" in both
        assert [v == "cached" for _, v in port[key]] == [v == "cached" for _, v in ref[key]], key
        for (got, _), (want, _), (plain, _) in zip(port[key], ref[key], off[key]):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=key)
            np.testing.assert_allclose(got, plain, atol=TOL, rtol=0, err_msg=key)
    # the exact match ran nothing, and its cached outputs are the first
    # session's rows
    assert port["s3"][0][1] == "cached"
    np.testing.assert_array_equal(port["s3"][0][0], port["s1"][0][0][:, : 2 * SEG])
    for event in seen["port"]:
        p, j = seen["port"][event], seen["jax"][event]
        assert p["summary"] == j["summary"], event
        assert p.get("forked") == j.get("forked"), event
    stats = seen["port"]["after_hits"]["delta"]
    assert stats["stored_segments"] == 2 and stats["hit_tokens"] == 4 * SEG
    if name in ("paged", "int8"):
        assert stats["page_hits"] == 2 and stats.get("device_hits", 0) == 0
        for kind in ("port", "jax"):
            rb = seen[kind]["after_rollback"]
            assert rb["forked"] == 1  # the pinned page was copied, not written
            for got, before in zip(rb["page2_bytes"], seen[kind]["after_hits"]["page2_bytes"]):
                np.testing.assert_array_equal(got, before)
        # s4 and s5 adopted the pages; s6 found the pins dead and read the host tier
        assert seen["port"]["after_reset"]["delta"]["page_hits"] == 4
        assert seen["port"]["after_reset"]["delta"].get("device_hits", 0) == 0
    else:
        assert stats["device_hits"] == 2 and stats.get("page_hits", 0) == 0
    if name != "dense":
        # the last session seeded from the device tier, after a promotion
        final = seen["port"]["after_promotion"]["delta"]
        assert final["promotions"] == 2
        assert final["device_hits"] == (1 if name != "private" else 3)
    info = servers.loop.run(pair["port"][1].call("ptu.info", {}, timeout=10))
    jinfo = servers.loop.run(pair["jax"][1].call("ptu.info", {}, timeout=10))
    assert info["prefix_cache"] == jinfo["prefix_cache"] == _pc(pair["port"][0]).summary()
    assert "prefix_cache" not in servers.loop.run(pair["off"][1].call("ptu.info", {}, timeout=10))


# ------------------------------------------------------------------ the keys


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_keys_match_petals_tpu(dtype):
    """Both packages hash the payload as it came off the wire, in the dtype
    the client sent: the keys agree, a changed row changes its segment's key
    and every later one, and the salt separates spans."""
    rng = np.random.RandomState(0)
    h = rng.randn(1, 3 * SEG + 17, 64).astype(np.float32)
    payload = h if dtype == "float32" else np.asarray(jnp.asarray(h, jnp.bfloat16))
    wire = serialize_array(payload)
    got = port_pc.segment_keys(port_deserialize(wire), "salt")
    assert got == jax_pc.segment_keys(deserialize_array(wire), "salt")
    assert len(got) == 3  # the 17-token tail never takes part
    changed = payload.copy()
    changed[:, SEG + 3] += 1
    keys2 = port_pc.segment_keys(port_deserialize(serialize_array(changed)), "salt")
    assert keys2[0] == got[0] and keys2[1] != got[1] and keys2[2] != got[2]
    assert port_pc.segment_keys(port_deserialize(wire), "other") != got
    assert jax_pc.SEGMENT_TOKENS == SEG


def test_resolve_device_bytes_matches_petals_tpu(monkeypatch):
    for frac in (None, "0.25", "7", "-1", "junk"):
        if frac is None:
            monkeypatch.delenv("PETALS_TPU_RADIX_DEVICE_FRAC", raising=False)
        else:
            monkeypatch.setenv("PETALS_TPU_RADIX_DEVICE_FRAC", frac)
        assert port_pc.resolve_device_bytes(1000, 300) == jax_pc.resolve_device_bytes(1000, 300)


# ------------------------------------------------------------------ the class


def _segments(seed, n):
    """k/v [2 blocks, 1, n segments, 2, 4] and out [1, n segments, 8], f32."""
    rng = np.random.RandomState(seed)
    k, v = (rng.randn(2, 1, n * SEG, 2, 4).astype(np.float32) for _ in range(2))
    return k, v, rng.randn(1, n * SEG, 8).astype(np.float32)


ENTRY_BYTES = 2 * 2 * SEG * 2 * 4 * 4 + SEG * 8 * 4
DEVICE_BYTES = 2 * 2 * SEG * 2 * 4 * 4


def _class_ops():
    """(op, args) sequence: chains that share a root and branch, probes,
    stores that overflow both budgets, re-stores that gain device copies,
    promotions."""
    a = _segments(1, 3)
    b = _segments(2, 3)
    c = _segments(3, 2)
    return [
        ("put", (["a0", "a1", "a2"], 0, *a, True)),
        ("put", (["a0", "b1", "b2"], 1, *(x[:, :, SEG:] if x.ndim == 5 else x[:, SEG:] for x in b), False)),
        ("probe", (["a0", "a1", "a2"],)),
        ("probe", (["a0", "b1", "zz"],)),
        ("probe", (["zz"],)),
        ("worth", (["a0", "a1"], 0, ENTRY_BYTES, False)),
        ("worth", (["a0", "b1"], 1, ENTRY_BYTES, True)),
        ("worth", (["a0", "q1"], 1, ENTRY_BYTES, False)),
        ("worth", (["a0"], 0, 100 * ENTRY_BYTES, False)),
        ("put", (["c0", "c1"], 0, *c, True)),  # over the host budget: leaves go, coldest first
        ("probe", (["c0", "c1"],)),
        ("probe", (["c0"],)),
        ("promote", (["c0", "c1"], 2)),
        ("probe", (["a0", "a1"],)),
        ("probe", (["a0", "a1"],)),
        ("promote", (["a0", "a1"], 2)),
        ("put", (["d0"], 0, *_segments(4, 1), True)),
        ("put", (["a0", "b1"], 0, *_segments(2, 2), True)),  # a re-store gains device copies
        ("worth", (["a0", "b1"], 0, ENTRY_BYTES, True)),
    ]


def _apply(cache, op, args, torch_side):
    if op == "put":
        keys, first, k, v, out, dev = args
        if torch_side:
            k, v, out = (torch.from_numpy(x.copy()) for x in (k, v, out))
            kd, vd = (k, v) if dev else (None, None)
        else:
            kd, vd = (jnp.asarray(k), jnp.asarray(v)) if dev else (None, None)
        return cache.put(keys, first, k, v, out, k_dev=kd, v_dev=vd)
    if op == "probe":
        return cache.probe(*args)
    if op == "worth":
        keys, first, nbytes, dev = args
        return cache.worth_storing(keys, first, nbytes, device_capable=dev)
    return cache.maybe_promote_device(*args)


def _store_view(cache):
    return [(key, e["hits"], e["depth"], e["parent"], sorted(e["children"]), "kd" in e) for key, e in cache._store.items()]


@pytest.mark.parametrize("policy", ["radix", "lru"])
def test_cache_class_matches_petals_tpu(policy):
    """The same operations on both classes give the same answers, the same
    victims (the store after each step, node by node) and the same
    summary; the host and device rows read back as stored."""
    kw = dict(device_max_bytes=3 * DEVICE_BYTES + 10, policy=policy)
    port = port_pc.PrefixCache(5 * ENTRY_BYTES + 10, **kw)
    ref = jax_pc.PrefixCache(5 * ENTRY_BYTES + 10, swap_pool=None, usage_fn=None, ledger=None, **kw)
    for op, args in _class_ops():
        assert _apply(port, op, args, True) == _apply(ref, op, args, False), (op, args)
        assert _store_view(port) == _store_view(ref), (op, args)
        assert port.summary() == ref.summary(), (op, args)
    assert port.stats["evictions"] > 0 and port.stats["device_evictions"] > 0
    for key, entry in port._store.items():
        want = ref._store[key]
        for name in ("k", "v", "out"):
            np.testing.assert_array_equal(entry[name].numpy(), want[name])
        if "kd" in entry:
            np.testing.assert_array_equal(entry["kd"].numpy(), np.asarray(want["kd"]))
            assert entry["kd"].data_ptr() != entry["k"].data_ptr()  # a copy, never a view
    k, v, out = port.get_range(["a0"], 1)
    np.testing.assert_array_equal(k.numpy(), ref.get_range(["a0"], 1)[0])
    port.clear()
    ref.clear()
    assert port.summary() == ref.summary()


def test_cache_refuses_the_tiers_not_ported_yet():
    for kw in ({"swap_pool": object()}, {"usage_fn": lambda peer: 0.0}, {"ledger": object()}):
        with pytest.raises(ValueError, match="not supported"):
            port_pc.PrefixCache(1 << 20, **kw)
    with pytest.raises(ValueError, match="policy"):
        port_pc.PrefixCache(1 << 20, policy="fifo")


# ------------------------------------------------------------------ the server


def test_handler_checks_page_size_and_scope():
    """petals_tpu's refusals: a paged pool whose page does not divide a
    segment (with the cache on), an unknown sharing scope."""
    from types import SimpleNamespace

    from petals_tpu_torch.server.handler import TransformerHandler

    backend = SimpleNamespace(device=torch.device("cpu"))

    def batcher(page_size):
        return SimpleNamespace(memory_cache=None, queue=None, page_size=page_size)

    with pytest.raises(ValueError, match="must divide the prefix-cache segment size"):
        TransformerHandler(backend, batcher(24), dht_prefix="p")
    TransformerHandler(backend, batcher(24), dht_prefix="p", prefix_cache_bytes=0)
    assert TransformerHandler(backend, batcher(None), dht_prefix="p").prefix_cache.device_max_bytes == 256 * 2**20
    with pytest.raises(ValueError, match="prefix_share_scope"):
        TransformerHandler(backend, batcher(16), dht_prefix="p", prefix_share_scope="tenant")


def test_cli_flags_match_petals_tpu(model_path):
    """The four flags with petals_tpu's defaults and choices reach the
    server; the Server's defaults are petals_tpu's too."""
    import inspect

    from petals_tpu.cli.run_server import build_parser as jax_parser
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    names = ("prefix_cache_bytes", "prefix_device_bytes", "prefix_cache_policy", "prefix_share_scope")
    port_actions = {a.dest: a for a in build_parser()._actions}
    jax_actions = {a.dest: a for a in jax_parser()._actions}
    for name in names:
        assert (port_actions[name].default, port_actions[name].choices) == (
            jax_actions[name].default, jax_actions[name].choices)
        assert inspect.signature(Server).parameters[name].default == \
            inspect.signature(JaxServer).parameters[name].default
    server = build_server(build_parser().parse_args([
        model_path, "--first_block", "0", "--num_blocks", "1", "--device", "cpu", "--throughput", "1",
        "--prefix_cache_bytes", "123", "--prefix_device_bytes", "0", "--prefix_cache_policy", "lru",
        "--prefix_share_scope", "peer",
    ]))
    assert (server.prefix_cache_bytes, server.prefix_device_bytes, server.prefix_cache_policy,
            server.prefix_share_scope) == (123, 0, "lru", "peer")


def test_greedy_tokens_match_petals_tpu(servers, model_path):
    """Greedy generation from a 140-token prompt, twice (a miss, then a hit
    of its first segment), on both servers with their caches on: every
    stream is the same, and the second one hit."""
    weights = load_file(os.path.join(model_path, "model.safetensors"))
    embed, norm_w, head = (weights[k] for k in ("model.embed_tokens.weight", "model.norm.weight", "lm_head.weight"))
    prompt = list(np.random.RandomState(5).randint(0, embed.shape[0], 140))
    uids = _uids(model_path, (0, N_LAYERS))
    pair = servers("paged")

    async def greedy(client, n_new=8):
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": MAX_LENGTH, "batch_size": 1})
        await stream.recv(timeout=60)
        tokens = list(prompt)
        hidden = embed[np.asarray(tokens)][None]
        for _ in range(n_new):
            await stream.send({"tensors": {"hidden": serialize_array(hidden.astype(np.float32))}})
            out = deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"])[0, -1].astype(np.float32)
            normed = out / np.sqrt(np.mean(out**2) + 1e-6) * norm_w
            tokens.append(int(np.argmax(normed @ head.T)))
            hidden = embed[tokens[-1:]][None]
        await stream.end()
        return tokens[len(prompt):]

    streams = {}
    for kind in ("port", "jax"):
        before = _pc(pair[kind][0]).stats["hit_tokens"]
        streams[kind] = [servers.loop.run(greedy(pair[kind][1])) for _ in range(2)]
        assert _pc(pair[kind][0]).stats["hit_tokens"] - before == SEG
    assert streams["port"][0] == streams["port"][1] == streams["jax"][0] == streams["jax"][1]


def test_peer_scope_matches_petals_tpu(model_path):
    """prefix_share_scope="peer": another proven client's identical prompt
    misses, the same client's repeat hits, and a client without a proven
    id is not cached at all; the stats and replies are petals_tpu's."""
    from petals_tpu.dht.identity import Identity

    loop = _Loop()
    uids = _uids(model_path, (0, N_LAYERS))
    shared, _, _, steps = _inputs(7, 64)

    async def run(start):
        server, anon = await start(model_path, 16, "none", prefix_share_scope="peer")
        host, port = anon._reader._transport.get_extra_info("peername")[:2] if False else (None, None)
        addr = (server.rpc_server.host, server.rpc_server.port)
        a = await RpcClient.connect(*addr, identity=Identity.from_seed(b"pc-a"))
        b = await RpcClient.connect(*addr, identity=Identity.from_seed(b"pc-b"))
        await a.wait_authenticated()
        await b.wait_authenticated()
        pc, marks, outs = _pc(server), [], []
        try:
            for client in (a, b, a, anon):
                outs.append(await _session(client, uids, [(shared, {}), (steps[0], {})]))
                marks.append({k: pc.stats.get(k, 0) for k in ("hits", "hit_tokens", "stored_segments", "page_hits")})
            return marks, outs, pc.summary()
        finally:
            for client in (a, b, anon):
                await client.close()
            await server.shutdown()

    try:
        port = loop.run(run(_port_server))
        ref = loop.run(run(_jax_server))
    finally:
        loop.close()
    assert port[0] == ref[0] and port[2] == ref[2]
    a1, b1, a2, anon = port[0]
    assert (a1["stored_segments"], a1["hit_tokens"]) == (2, 0)
    assert (b1["stored_segments"], b1["hit_tokens"]) == (4, 0)  # stored under B's salt
    assert a2["hit_tokens"] == 2 * SEG and a2["page_hits"] == 1
    assert anon == a2  # no identity: neither probed nor stored
    for got, want in zip(port[1], ref[1]):
        for (g, _), (w, _) in zip(got, want):
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
    for out in port[1][1:]:
        np.testing.assert_allclose(out[0][0], port[1][0][0][0], atol=TOL, rtol=0)


def test_cancelled_store_releases_its_pins(servers):
    """A store cancelled while it waits for its snapshot (the session torn
    down mid-store) leaves every page refcount where it was before the pin,
    and stores nothing."""
    server = servers("paged")["port"][0]
    handler, batcher = server.handler, server.handler.batcher
    rng = np.random.RandomState(11)
    prompt = torch.from_numpy(rng.randn(1, 2 * SEG, 64).astype(np.float32) * 0.1)
    keys = port_pc.segment_keys(prompt, "cancelled-store")

    async def main():
        lane = await batcher.acquire_lane(timeout=10)
        gate, real = asyncio.Event(), batcher.snapshot_lane

        async def stalled(*args, **kwargs):
            await gate.wait()
            return await real(*args, **kwargs)

        try:
            out = await batcher.prefill_lane(lane, prompt, 0)
            refs = batcher._pages.refs.copy()
            batcher.snapshot_lane = stalled
            task = asyncio.create_task(handler._store_prefix_async(
                keys, 0, 2 * SEG, batcher, lane, None, out, N_LAYERS))
            await asyncio.sleep(0.05)
            pinned = batcher._pages.refs.copy()
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            return refs, pinned, batcher._pages.refs.copy(), batcher._tables[lane, :16].copy()
        finally:
            del batcher.snapshot_lane
            batcher.release_lane(lane)

    stored = _pc(server).stats["stored_segments"]
    refs, pinned, after, row = servers.loop.run(main())
    assert (pinned - refs)[row].tolist() == [1] * 16 and (pinned - refs).sum() == 16
    np.testing.assert_array_equal(after, refs)
    assert _pc(server).stats["stored_segments"] == stored and keys[0] not in _pc(server)._store


@pytest.mark.parametrize("kind", ["int8", "nf4a"])
def test_insert_reencodes_shared_pages_as_petals_tpu(kind):
    """The paged check-in of an exclusive op scatters EVERY allocated slot
    of the lane back, re-encoding it from its decoded (bfloat16) rows:
    pages the lane shares with the prefix cache included. Both packages do
    it, and leave the same codes and scales, byte for byte (ROADMAP Queue
    C: the shared pages' scales move)."""
    from types import SimpleNamespace

    from petals_tpu.ops.paged_attention import PagedPool as JaxPool
    from petals_tpu.server.backend import TransformerBackend as JaxBackend
    from petals_tpu_torch.ops.paged_attention import PagedPool, quantize_kv_rows
    from petals_tpu_torch.server.backend import TransformerBackend

    rng = np.random.RandomState(17)
    pools = [PagedPool(*quantize_kv_rows(torch.from_numpy(rng.randn(2, 6, 16, 2, 8).astype(np.float32)), kind))
             for _ in range(2)]
    # copies: jnp.asarray of a numpy array may share its memory, and the
    # port scatters in place
    jax_pools = [JaxPool(jnp.array(p.codes.numpy().copy()), jnp.array(p.scales.numpy().copy())) for p in pools]
    before = [(p.codes.clone(), p.scales.clone()) for p in pools]
    row = np.array([3, 1, -1, 0], np.int32)  # a hole, pages out of order
    gather = JaxBackend._paged_lane_gather_fn.func(None)
    scatter = JaxBackend._paged_lane_scatter_fn.func(None)
    jk, jv = gather(*jax_pools, jnp.asarray(row))
    jax_after = scatter(*jax_pools, jk, jv, jnp.asarray(row))
    backend = SimpleNamespace(device=torch.device("cpu"))
    k, v = TransformerBackend.paged_lane_gather(backend, *pools, row)
    np.testing.assert_array_equal(k.float().numpy(), np.asarray(jk, np.float32))
    TransformerBackend.paged_lane_scatter(backend, *pools, k, v, row)
    for pool, want, (codes, scales) in zip(pools, jax_after, before):
        np.testing.assert_array_equal(pool.codes.numpy(), np.asarray(want.codes))
        np.testing.assert_array_equal(pool.scales.numpy(), np.asarray(want.scales))
        # only the table's pages were written
        for page in (2, 4, 5):
            assert torch.equal(pool.codes[:, page], codes[:, page]) and torch.equal(pool.scales[:, page], scales[:, page])


def test_exclusive_pass_over_adopted_pages(servers, model_path):
    """A lane that adopted an int8 pool's pinned pages, then takes an
    exclusive pass (a step with hypo_ids), answers as the same sessions on a
    server with the cache off; the pass re-encodes the shared pages (the
    test above). petals_tpu serves no exclusive pass on a quantized pool
    at float32 (its scan's carry types differ), so this one is held to the
    port's cache-off server."""
    pair = servers("int8")
    uids = _uids(model_path, (0, N_LAYERS))
    rng = np.random.RandomState(13)
    prompt = rng.randn(1, 2 * SEG + 3, 64).astype(np.float32) * 0.1
    step = rng.randn(1, 1, 64).astype(np.float32) * 0.1
    hypo = {"tensors": {"hypo_ids": serialize_array(np.zeros((1,), np.int64))}}
    runs = {}
    for kind in ("port", "off"):
        client = pair[kind][1]
        first = servers.loop.run(_session(client, uids, [(prompt, {}), (step, {})]))
        runs[kind] = first + servers.loop.run(_session(client, uids, [(prompt, {}), (step, hypo)]))
    assert runs["port"][2][1] == "prefill" and _pc(pair["port"][0]).stats["page_hits"] >= 1
    for (got, _), (want, _) in zip(runs["port"], runs["off"]):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("device_bytes", [256 * 2**20, 0, 2**40])
def test_auto_kv_budget_gives_up_the_hbm_tier(model_path, device_bytes):
    """An auto-sized KV budget leaves the HBM tier's bytes out, floored at a
    quarter of it, as petals_tpu's does; an explicit budget is kept."""
    port = Server(model_path, first_block=0, num_blocks=1, device="cpu", throughput=1.0,
                  prefix_device_bytes=device_bytes)
    ref = JaxServer(model_path, first_block=0, num_blocks=1, throughput=1.0, prefix_device_bytes=device_bytes)
    assert port.memory_cache.max_size_bytes == ref.attn_cache_bytes
    assert port.memory_cache.max_size_bytes == max((2 << 30) - device_bytes, (2 << 30) // 4)
    explicit = Server(model_path, first_block=0, num_blocks=1, device="cpu", throughput=1.0, attn_cache_bytes=1 << 20)
    assert explicit.memory_cache.max_size_bytes == 1 << 20
