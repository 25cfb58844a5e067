"""Server-side generation of the port (server/backend.py, batching.py,
handler.py, server.py) against petals_tpu's, on the CPU in float32 over
tiny-llama (2 blocks, the client's float32 leaves on both sides):

- ``sample_from_hidden``, ``paged_gen_decode_step`` (a float32 and an int8
  pool), ``batched_gen_decode_step`` and ``generate_tokens`` (greedy,
  seeded sampling, a repetition penalty) against petals_tpu's
  ``TransformerBackend``: tokens equal, hidden states and pools within
  2e-5 (as every other step of the port is held to JAX's); the generation
  step's pool bytes equal to the port's own decode step fed the same
  embeddings, and its step program (a stand-in capture that replays by
  re-running, tests/test_torch_step_programs.py) byte-identical to its eager
  loop.
- The batcher: two generating lanes, a decoding lane and a prefill arriving
  mid-generation share ticks (one generation step for the three, the chunk
  in a mixed step beside it), and every lane's tokens and outputs equal
  petals_tpu's batcher's in the same scenario.
- A whole-model port Server answers ``gen_tokens`` streams (greedy, seeded,
  penalised; a clamped ``gen_tokens=20``; pooled and private sessions) with
  a petals_tpu Server's tokens and positions; it refuses batch-2 and
  sub-span generation with petals_tpu's message, and announces
  ``server_gen`` / ``server_gen_sampling`` on the whole model only, and not
  with ``server_side_generation=False``."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.from_pretrained import load_client_params as jax_load_client
from petals_tpu.rpc import RpcClient, RpcError
from petals_tpu.rpc.serialization import serialize_array
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.batching import DecodeBatcher as JaxBatcher
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.server.server import Server as JaxServer
from petals_tpu.server.task_queue import PriorityTaskQueue as JaxQueue
from petals_tpu_torch.client.from_pretrained import load_client_params
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.test_torch_server import _uids
from tests.test_torch_step_programs import StubCapture, _clone_pools, _tensors
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)

TOL = 2e-5
N_LAYERS = 2
PS = 16
SAMPLED = {"do_sample": True, "temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 7}
PENALISED = {"repetition_penalty": 1.3, "seed": 3}
SAMPLINGS = {"greedy": None, "sampled": SAMPLED, "penalised": PENALISED}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


_BACKENDS = {}


def _backends(path, kv="none"):
    """(JAX backend, port backend, JAX client leaves, port client leaves)
    over the same float32 blocks of ``path``, the pools encoded as ``kv``."""
    if (path, kv) not in _BACKENDS:
        jfamily, jcfg = jax_block_config(path)
        blocks = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(N_LAYERS)]
        jax_backend = JaxBackend(
            jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks), first_block=0,
            n_blocks=N_LAYERS, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
            kv_quant_type=kv,
        )
        family, cfg = get_block_config(path)
        backend = TransformerBackend(
            family, cfg, stacked_from_numpy([{k: np.asarray(v) for k, v in b.items()} for b in blocks], "cpu",
                                            torch.float32),
            first_block=0, n_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32, kv_quant_type=kv,
        )
        jparams = jax_load_client(path, dtype=jnp.float32, family=jfamily, cfg=jcfg)
        _BACKENDS[(path, kv)] = (jax_backend, backend, jparams, load_client_params(path, device="cpu"))
    return _BACKENDS[(path, kv)]


def _vecs(n, vocab, rng):
    """Per-lane sampling vectors: lane 0 greedy, 1 sampled, 2 penalised
    greedy over a seen mask, 3 everything at once; seeds and draws random."""
    from petals_tpu.ops.sampling import sampling_vectors

    vec = sampling_vectors(n, vocab)
    vec["do_sample"][[1, 3]] = True
    vec["temperature"][[1, 3]] = (0.8, 1.3)
    vec["top_k"][3] = 10
    vec["top_p"][[1, 3]] = (0.9, 0.7)
    vec["repetition_penalty"][[2, 3]] = (1.5, 1.2)
    vec["seen_mask"][2:4] = rng.random((2, vocab)) < 0.2
    vec["seeds"][:] = rng.integers(0, 2**31, n)
    vec["draw_idx"][:] = rng.integers(0, 100, n)
    return vec


def test_sample_from_hidden_equals_petals_tpu(model_path):
    jb, pb, jparams, params = _backends(model_path)
    hidden = np.random.default_rng(0).standard_normal((2, 3, pb.hidden_size)).astype(np.float32)
    for sampling in (None, SAMPLED, {**PENALISED, "context": [1, 5, 9]}, {**SAMPLED, "offset": 11}):
        want = jb.sample_from_hidden(jparams, hidden, sampling)
        got = pb.sample_from_hidden(params, torch.from_numpy(hidden), sampling)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _paged_scene(rng, cfg, kv):
    """4 lanes of 8 table slots over 20 permuted pages: lanes 0 and 2
    generate (their previous tokens), lane 1 decodes a hidden state, lane 3
    idles at the sentinel; the pools seeded, as (JAX, port) pairs."""
    from petals_tpu.ops import paged_attention as J
    from petals_tpu_torch.ops import paged_attention as T

    n_lanes, max_pages, n_pages = 4, 8, 20
    tables = np.full((n_lanes, max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    positions = np.array([9, 30, 17, PS * max_pages], np.int32)
    for lane in range(3):
        for s in range(positions[lane] // PS + 1):
            tables[lane, s] = free.pop()
    shape = (N_LAYERS, n_pages, PS, cfg.num_key_value_heads, cfg.head_dim)
    jpools, tpools = [], []
    for _ in range(2):
        rows = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        if kv == "none":
            jpools.append(jnp.asarray(rows))
            tpools.append(torch.from_numpy(rows.copy()))
        else:
            codes, scales = jax.jit(J.quantize_kv_rows, static_argnums=1)(jnp.asarray(rows), kv)
            jpools.append(J.PagedPool(codes, scales))
            tpools.append(T.PagedPool(torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scales))))
    hidden = (rng.standard_normal((n_lanes, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    tokens = np.array([5, 0, 77, 0], np.int32)
    use_token = np.array([True, False, True, False])
    return tables, tuple(jpools), tuple(tpools), positions, hidden, tokens, use_token


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_paged_gen_decode_step_equals_petals_tpu(model_path, kv):
    jb, pb, jparams, params = _backends(model_path, kv)
    rng = np.random.default_rng(1)
    tables, jpools, tpools, positions, hidden, tokens, use_token = _paged_scene(rng, pb.cfg, kv)
    vec = _vecs(4, pb.cfg.vocab_size, rng)
    decode_pools = _clone_pools(tpools)
    want_h, want_tok, jpools = jb.paged_gen_decode_step(
        jparams, hidden, tokens, use_token, jpools, positions, tables, sampling_vecs=vec)
    got_h, got_tok, _ = pb.paged_gen_decode_step(
        params, hidden, tokens, use_token, tpools, positions, tables, sampling_vecs=vec)
    active = [0, 1, 2]
    np.testing.assert_array_equal(got_tok.numpy()[active], np.asarray(want_tok)[active])
    np.testing.assert_allclose(got_h.numpy()[active], np.asarray(want_h)[active], atol=TOL, rtol=0)
    if kv == "none":
        for got, want in zip(tpools, jpools):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    else:  # a code may sit a step apart where a value rounds on a midpoint
        for got, want in zip(tpools, jpools):
            assert np.abs(got.codes.numpy().astype(int) - np.asarray(want.codes).astype(int)).max() <= 1
    # the generating lanes' inputs are the embeddings: the port's own decode
    # step fed them writes the same bytes and gives the same outputs
    fed = np.where(use_token[:, None, None], params["embed"].numpy()[tokens][:, None], hidden)
    dec_h, _ = pb.paged_decode_step(fed, decode_pools, positions, tables)
    assert torch.equal(dec_h, got_h)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(tpools), _tensors(decode_pools)))


def test_gen_step_program_replays_equal_the_eager_step(model_path):
    """The card's path (a step program per key) through a stand-in capture:
    byte-identical to the eager step on cloned pools, one graph for every
    call of one pool, and warming the pool with client leaves captures it."""
    from petals_tpu_torch.telemetry.observatory import Observatory, TrackedGraph

    _, pb, _, params = _backends(model_path, "int8")
    obs = Observatory()
    stub = TransformerBackend.__new__(TransformerBackend)
    stub.__dict__.update(pb.__dict__)
    capture = StubCapture()
    for name in ("_decode_program", "_mixed_program", "_gen_program"):
        setattr(stub, name, TrackedGraph(name, capture, observatory=obs))
    rng = np.random.default_rng(2)
    tables, _, pools, positions, hidden, tokens, use_token = _paged_scene(rng, pb.cfg, "int8")
    eager_pools = _clone_pools(pools)
    for step in range(3):
        vec = _vecs(4, pb.cfg.vocab_size, rng)
        got = stub.paged_gen_decode_step(params, hidden, tokens, use_token, pools, positions, tables, sampling_vecs=vec)
        want = pb.paged_gen_decode_step(params, hidden, tokens, use_token, eager_pools, positions, tables,
                                        sampling_vecs=vec)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(_tensors(pools), _tensors(eager_pools)))
        tokens = got[1].numpy().astype(np.int32) * use_token
        positions = positions + np.array([1, 1, 1, 0], np.int32)
    assert stub._gen_program.counts.captures == 1 and stub._gen_program.counts.replays == 3
    fresh = _clone_pools(pools)
    before = [t.clone() for t in _tensors(fresh)]
    stub.warm_step_programs(fresh, 4, tables.shape[1], 16, params)
    assert stub._gen_program.counts.captures == 2  # a fresh pool: its own graph
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(fresh)))  # the warm-up wrote nothing


def test_batched_gen_decode_step_equals_petals_tpu(model_path):
    jb, pb, jparams, params = _backends(model_path)
    rng = np.random.default_rng(3)
    n_lanes, max_len = 4, 48
    shape = (N_LAYERS, n_lanes, max_len, pb.num_kv_heads, pb.head_dim)
    rows = [(rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(2)]
    positions = np.array([9, 30, 17, max_len], np.int32)
    hidden = (rng.standard_normal((n_lanes, 1, pb.hidden_size)) * 0.1).astype(np.float32)
    tokens, use_token = np.array([5, 0, 77, 0], np.int32), np.array([True, False, True, False])
    vec = _vecs(n_lanes, pb.cfg.vocab_size, rng)
    want_h, want_tok, (jk, jv) = jb.batched_gen_decode_step(
        jparams, hidden, tokens, use_token, tuple(jnp.asarray(r) for r in rows), positions, sampling_vecs=vec)
    got_h, got_tok, (tk, tv) = pb.batched_gen_decode_step(
        params, hidden, tokens, use_token, tuple(torch.from_numpy(r.copy()) for r in rows), positions,
        sampling_vecs=vec)
    np.testing.assert_array_equal(got_tok.numpy()[:3], np.asarray(want_tok)[:3])
    np.testing.assert_allclose(got_h.numpy()[:3], np.asarray(want_h)[:3], atol=TOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", list(SAMPLINGS))
def test_generate_tokens_equals_petals_tpu(model_path, mode):
    """A private session's loop: a 7-token prompt, then 12 tokens generated
    (11 fed); tokens equal, the caches within 2e-5."""
    jb, pb, jparams, params = _backends(model_path)
    sampling = SAMPLINGS[mode]
    if sampling is not None:
        sampling = {**sampling, "offset": 2, "context": [4, 9, 9, 30]}
    prompt = np.random.default_rng(4).standard_normal((1, 7, pb.hidden_size)).astype(np.float32)
    kd, vd = jb.cache_descriptors(1, 32, 0, N_LAYERS)
    jkv = (kd.make_zeros(), vd.make_zeros())
    jout, jkv = jb.inference_step(prompt, jkv, 0)
    want, jkv = jb.generate_tokens(jparams, np.asarray(jout)[:, -1:], jkv, 7, 12, sampling=sampling)
    pkv = tuple(torch.zeros(N_LAYERS, 1, 32, pb.num_kv_heads, pb.head_dim) for _ in range(2))
    pout, pkv = pb.inference_step(prompt, pkv, 0)
    got, pkv = pb.generate_tokens(params, pout[:, -1:], pkv, 7, 12, sampling=sampling)
    assert got.shape == (1, 12) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    for g, w in zip(pkv, jkv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="overflows"):
        pb.generate_tokens(params, pout[:, -1:], pkv, 30, 4)


async def _batcher_scenario(batcher, to_input, to_host, embed):
    """Lanes 0 and 1 prefill, then generate 12 tokens each (0 greedy, 1
    sampled) while lane 2 decodes 6 steps and lane 3's 40-token prefill
    arrives once both are generating. Returns every lane's result."""
    rng = np.random.default_rng(5)
    hsz = embed.shape[1]
    prompts = [to_input((rng.standard_normal((1, n, hsz)) * 0.3).astype(np.float32)) for n in (9, 20, 5, 40)]
    lanes = [await batcher.acquire_lane(timeout=30) for _ in range(4)]
    outs = [to_host(await batcher.prefill_lane(lanes[i], prompts[i], 0)) for i in range(3)]

    async def decode():
        got = []
        for step in range(6):
            h = to_host(await batcher.step(lanes[2], to_input(embed[[11 + step]][None]), 5 + step))
            got.append(h)
        return got

    async def late_prefill():
        while len(batcher._gen_states) < 2:
            await asyncio.sleep(0.001)
        return to_host(await batcher.prefill_lane(lanes[3], prompts[3], 0))

    results = await asyncio.gather(
        batcher.generate_lane(lanes[0], to_input(outs[0][:, -1:]), 9, 12),
        batcher.generate_lane(lanes[1], to_input(outs[1][:, -1:]), 20, 12, sampling={**SAMPLED, "offset": 0}),
        decode(), late_prefill(),
    )
    return [np.asarray(results[0]), np.asarray(results[1]), np.concatenate(results[2], axis=1), results[3]]


def test_generate_lane_shares_ticks_and_equals_petals_tpu(model_path):
    jb, pb, jparams, params = _backends(model_path)
    embed = params["embed"].numpy()

    async def run_jax():
        queue = JaxQueue()
        queue.start()
        batcher = JaxBatcher(jb, JaxMemoryCache(1 << 30), queue, n_lanes=4, max_length=64, page_size=PS,
                             prefill_token_budget=16, gen_params=jparams)
        try:
            return await _batcher_scenario(batcher, np.asarray, np.asarray, embed)
        finally:
            await batcher.close()
            queue.shutdown()

    ticks = []

    async def run_port():
        queue = PriorityTaskQueue()
        queue.start()
        batcher = DecodeBatcher(pb, MemoryCache(1 << 30), queue, n_lanes=4, max_length=64, page_size=PS,
                                prefill_token_budget=16, gen_params=params)
        run_gen, run_mixed = batcher._run_batch_gen, batcher._run_batch_mixed

        def gen_tick(batch, gen_states):
            ticks.append(("gen", len(gen_states), len(batch)))
            return run_gen(batch, gen_states)

        def mixed_tick(batch, pf):
            ticks.append(("mixed", 0, len(batch)))
            return run_mixed(batch, pf)

        batcher._run_batch_gen, batcher._run_batch_mixed = gen_tick, mixed_tick
        try:
            results = await _batcher_scenario(batcher, torch.from_numpy, lambda t: t.numpy(), embed)
            return results, dict(batcher.stats)
        finally:
            await batcher.close()
            queue.shutdown()

    want = asyncio.run(run_jax())
    got, stats = asyncio.run(run_port())
    for i in (0, 1):
        assert got[i].shape == (1, 12)
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], atol=TOL, rtol=0)
    assert stats["gen_steps"] > 0 and stats["max_gen_lanes"] == 2 and stats["gen_lane_tokens"] == 22
    # a tick with both generating lanes and the decoding lane, and a chunk
    # that rode its own mixed step right after a generation step
    assert ("gen", 2, 1) in ticks
    assert any(a[0] == "gen" and b == ("mixed", 0, 0) for a, b in zip(ticks, ticks[1:]))


async def _gen_stream(client, uids, embed, prompt, chunks, sampling, max_length=64):
    """The client's protocol over raw ptu.inference steps: the prompt's
    embeddings with the first chunk's ``gen_tokens``, then the pending last
    token's embedding with each next one (``offset``: the tokens drawn so
    far). Returns the tokens, the replies' positions and variants."""
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": max_length, "batch_size": 1})
    await stream.recv(timeout=60)
    tokens, positions, variants = list(prompt), [], []
    pending = embed[np.asarray(prompt)][None]
    for n in chunks:
        step = {"tensors": {"hidden": serialize_array(pending.astype(np.float32))}, "gen_tokens": n}
        if sampling is not None:
            step["gen_sampling"] = {**sampling, "offset": len(tokens) - len(prompt), "context": tokens}
        await stream.send(step)
        reply = await stream.recv(timeout=120)
        tokens += reply["tokens"]
        positions.append(reply["position"])
        variants.append(reply["step_meta"]["variant"])
        pending = embed[tokens[-1:]][None]
    await stream.end()
    return tokens[len(prompt):], positions, variants


def _port_server(path, **kw):
    return Server(path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
                  batch_lanes=2, batch_max_length=64, page_size=PS, prefill_token_budget=16, throughput=1.0, **kw)


def test_server_gen_streams_equal_petals_tpu_server(model_path):
    """Greedy, seeded and penalised streams of 16 + 4 tokens (the first
    chunk asks for 20: both servers clamp it to 16), on a pooled session
    and on a private one (max_length past the lanes)."""
    prompt = [3, 17, 42, 5, 99]
    uids = _uids(model_path)
    embed = _backends(model_path)[3]["embed"].numpy()
    cases = [(mode, max_length) for mode in SAMPLINGS for max_length in (64, 100)]

    async def run(make_server):
        server = make_server()
        await server.start()
        client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
        try:
            return [await _gen_stream(client, uids, embed, prompt, (20, 4), SAMPLINGS[mode], max_length)
                    for mode, max_length in cases], getattr(server, "batcher", None)
        finally:
            await client.close()
            await server.shutdown()

    got, port_batcher = asyncio.run(run(lambda: _port_server(model_path)))
    want, _ = asyncio.run(run(lambda: JaxServer(
        model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0, batching=True, batch_lanes=2,
        batch_max_length=64, page_size=PS, prefix_cache_bytes=0, prefix_device_bytes=0,
    )))
    assert port_batcher.stats["gen_steps"] > 0
    for (mode, max_length), (tokens, positions, variants), (jtokens, jpositions, _) in zip(cases, got, want):
        assert len(tokens) == 16 + 4, (mode, max_length)
        assert tokens == jtokens, (mode, max_length)
        assert positions == jpositions == [len(prompt) + 15, len(prompt) + 15 + 4], (mode, max_length)
        assert variants == (["prefill+gen", "decode+gen"] if max_length == 64 else ["private", "private"])


def test_server_gen_refusals_and_announce(model_path):
    """Batch-2 and sub-span sessions are refused with petals_tpu's message;
    the announce says server_gen on the whole model only."""
    hsz = _backends(model_path)[1].hidden_size

    async def main():
        server = _port_server(model_path)
        await server.start()
        client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
        try:
            info = server._server_info(server._state)
            assert info.server_gen is True and info.server_gen_sampling is True
            for open_msg, batch in (({"batch_size": 2}, 2), ({"uids": _uids(model_path).split(" ")[0]}, 1)):
                stream = await client.open_stream("ptu.inference")
                await stream.send({"uids": _uids(model_path), "max_length": 64, "batch_size": 1, **open_msg})
                assert (await stream.recv(timeout=60))["session_open"]
                await stream.send({"tensors": {"hidden": serialize_array(np.zeros((batch, 2, hsz), np.float32))},
                                   "gen_tokens": 4})
                with pytest.raises(RpcError, match="server-side generation is not available for this session"):
                    await stream.recv(timeout=60)
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": _uids(model_path), "max_length": 8, "batch_size": 1})
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": serialize_array(np.zeros((1, 2, hsz), np.float32))},
                               "gen_tokens": 8})
            with pytest.raises(RpcError, match="exceeds max_length 8"):
                await stream.recv(timeout=60)
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": _uids(model_path), "max_length": 64, "batch_size": 1})
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": serialize_array(np.zeros((1, 2, hsz), np.float32))},
                               "gen_tokens": 4, "gen_sampling": {"top_p": 2.0}})
            with pytest.raises(RpcError, match="top_p must be in"):
                await stream.recv(timeout=60)
        finally:
            await client.close()
            await server.shutdown()
        for kw in ({"server_side_generation": False}, {"num_blocks": 1}):
            off = Server(model_path, **{"first_block": 0, "num_blocks": N_LAYERS, "device": "cpu",
                                        "compute_dtype": torch.float32, "throughput": 1.0, **kw})
            await off.start()
            try:
                info = off._server_info(off._state)
                assert info.server_gen is False and info.server_gen_sampling is False
                assert off.server_gen_params is None and off.batcher.gen_params is None
            finally:
                await off.shutdown()

    asyncio.run(asyncio.wait_for(main(), 120))
