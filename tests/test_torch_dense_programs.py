"""The dense-cache step programs of the port (server/backend.py: the private
step, the dense pool's batched decode and lane programs, the private and
pooled generation steps, the stateless forward) on the CPU, against the JAX
package, over tiny-llama in float32.

Every case goes through the capture path (``TrackedGraph``) with a stand-in
capture (tests/test_torch_step_programs.py ``StubCapture``; here
``OnceCapture``, under which a capture and the replay that follows it run a
step once, as on the card, so a step whose effect does not repeat, a beam
reorder, is held to the eager loop exactly): a non-steady key's first call
runs eagerly, its second captures and replays, later calls replay; a steady
program is captured when its pool opens.

- Private steps: chunks of 5, 8, 13 and 300 rows (padded to 8, 8, 16 and
  512, the last past the buffer's end) and decode tokens, at batch 1 and 2,
  with hypo_ids, with deep prompts that straddle a chunk, and on a sub-span:
  outputs and both caches against the JAX package's ``inference_step``
  (XLA attention: 2e-5; its Pallas flash kernel in interpret mode: 1e-4),
  and bit-equal to the port's eager block loop on a copy of the caches.
- The device-scalar arms: ``update_kv_cache`` with 0-dim tensor position and
  n_valid writes the bytes the host-integer arm writes (padded rows and rows
  past the buffer drop); ``flash_attend_reference`` with tensor scalars
  equals its host-integer form and the JAX kernel in interpret mode.
- Keys and counts: ``dense_program_key`` separates the cache's address,
  batch, bucket, hypo_ids and pre_seq; a non-steady program captures a key
  on its second call and never counts an anomaly, a steady one does after
  its warm-up; a private cache's graphs go when the handler frees it.
- The dense pool: warming it captures the batched decode step, the
  generation step and every lane-and-bucket program, after which a batcher
  serving prefills, decode steps and exclusive ops captures no steady
  program; a prefill on a lane's view equals the extract / insert path and
  the JAX package's.
- ``generate_tokens`` (greedy, seeded sampling) and
  ``batched_gen_decode_step`` give petals_tpu's tokens; ``forward``, with
  and without deep prompts, equals the JAX package's.

Arrays from JAX are copied before the port sees them: it writes caches in
place."""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.from_pretrained import load_client_params as jax_load_client
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch.client.from_pretrained import load_client_params
from petals_tpu_torch.models.common import update_kv_cache
from petals_tpu_torch.ops import flash_attention as fa
from petals_tpu_torch.server.backend import TransformerBackend, bucket_length, chunk_buckets, dense_program_key
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.handler import TransformerHandler
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.telemetry.observatory import DEFAULT_WARMUP_CALLS, Observatory, TrackedGraph, count_launch
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.test_torch_flash_attention import CASES, _case, _jax_kwargs, jax_flash
from tests.test_torch_step_programs import StubCapture, StubGraph
from tests.utils import make_tiny_llama

TOL = {False: 2e-5, True: 1e-4}  # by the JAX side's use_flash (tests/test_torch_dense.py)
N_LAYERS = 3
MAXLEN = 384  # a multiple of 128, so the JAX flash kernel takes the cache
SAMPLED = {"do_sample": True, "temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 7}

# the backend's dense programs: (attribute, name, steady)
PROGRAMS = (
    ("_dense_decode_program", "batched_decode", True),
    ("_dense_gen_program", "batched_gen_decode", True),
    ("_lane_program", "dense_lane_step", True),
    ("_private_program", "inference_step", False),
    ("_private_gen_program", "server_gen", False),
    ("_forward_program", "forward", False),
)


class OnceCapture(StubCapture):
    """``StubCapture`` whose warm-up returns the step's outputs (a
    non-steady key's eager call) and whose capture runs the step to make
    its outputs, the run that the replay right after a capture does on the
    card: that first replay does nothing more. So a capture and its replay
    run a step once, and later replays run it again on the new inputs."""

    def warm(self, fn, inputs):
        self.warms += 1
        return fn(*inputs)

    def capture(self, fn, inputs):
        graph, outputs = super().capture(fn, inputs)
        return _OnceGraph(fn, inputs, outputs), outputs


class _OnceGraph(StubGraph):
    def __init__(self, fn, inputs, outputs):
        super().__init__(fn, inputs, outputs)
        self.captured = True

    def replay(self):
        if self.captured:  # the capture ran the step: this is its first run
            self.captured = False
            return
        super().replay()


def _stubbed(backend):
    """A copy of ``backend`` whose dense steps take the card's path through
    an ``OnceCapture``, and its observatory."""
    obs, capture = Observatory(), OnceCapture()
    stub = TransformerBackend.__new__(TransformerBackend)
    stub.__dict__.update(backend.__dict__)
    stub._lane_views = set()
    for attr, name, steady in PROGRAMS:
        setattr(stub, attr, TrackedGraph(name, capture, steady=steady, observatory=obs))
    return stub, obs


def _counts(stub, attr):
    c = getattr(stub, attr).counts
    return {"eager": c.eager_calls, "captures": c.captures, "replays": c.replays, "anomalies": c.anomalies}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


_BACKENDS = {}


def _backends(path, use_flash=False, span=(0, N_LAYERS)):
    """(JAX backend, port backend) over blocks [span) of ``path`` in float32."""
    key = (path, use_flash, span)
    if key not in _BACKENDS:
        jfamily, jcfg = jax_block_config(path)
        blocks = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(*span)]
        n = span[1] - span[0]
        jax_backend = JaxBackend(
            jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks), first_block=span[0],
            n_blocks=n, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=use_flash,
        )
        family, cfg = get_block_config(path)
        backend = TransformerBackend(
            family, cfg, stacked_from_numpy([{k: np.asarray(v) for k, v in b.items()} for b in blocks], "cpu",
                                            torch.float32),
            first_block=span[0], n_blocks=n, device="cpu", compute_dtype=torch.float32, use_flash=use_flash,
        )
        _BACKENDS[key] = (jax_backend, backend)
    return _BACKENDS[key]


def _zeros(jax_backend, backend, batch, max_length=MAXLEN):
    kd, vd = jax_backend.cache_descriptors(batch, max_length, 0, backend.n_blocks)
    return (kd.make_zeros(), vd.make_zeros()), tuple(d.make_zeros() for d in backend.cache_descriptors(
        batch, max_length, 0, backend.n_blocks))


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want),
                               atol=tol, rtol=0)


# ------------------------------------------------------------------ private steps


def _session(case, rng, hsz):
    """(span, batch, steps): each step (tokens, kwargs)."""
    def h(batch, seq):
        return (rng.standard_normal((batch, seq, hsz)) * 0.1).astype(np.float32)

    lengths = (5, 8, 13, 1, 1, 300, 1)  # buckets 8, 8, 16, 0, 0, 512 (past the buffer's end), 0
    if case in ("batch1", "batch2"):
        batch = 1 if case == "batch1" else 2
        return (0, N_LAYERS), batch, [(h(batch, n), {}) for n in lengths]
    if case == "hypo_ids":
        hypo = [np.array(x, np.int32) for x in ([1, 0], [1, 0], [0, 0], [1, 1])]
        return (0, N_LAYERS), 2, [(h(2, 13), {}), (h(2, 1), {"hypo_ids": hypo[0]}), (h(2, 1), {"hypo_ids": hypo[1]}),
                                  (h(2, 1), {"hypo_ids": hypo[2]}), (h(2, 8), {"hypo_ids": hypo[3]}), (h(2, 1), {})]
    if case == "deep_prompts":
        prompts = (rng.standard_normal((N_LAYERS, 2, 10, hsz)) * 0.1).astype(np.float32)
        # the second chunk [5, 13) straddles the prompts' [0, 10)
        return (0, N_LAYERS), 2, [(h(2, n), {"prompts": prompts}) for n in (5, 8, 1, 1, 13)]
    if case == "sub_span":
        return (1, N_LAYERS), 1, [(h(1, n), {}) for n in (13, 1, 1, 1)]
    raise KeyError(case)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("case", ["batch1", "batch2", "hypo_ids", "deep_prompts", "sub_span"])
def test_private_step_program_matches_jax_and_the_eager_loop(model_path, case, use_flash):
    span, batch, steps = _session(case, np.random.default_rng(0), 64)
    jax_backend, backend = _backends(model_path, use_flash, span)
    stub, obs = _stubbed(backend)
    jkv, tkv = _zeros(jax_backend, backend, batch)
    eager_kv = tuple(t.clone() for t in tkv)
    position = 0
    for hidden, kw in steps:
        want, jkv = jax_backend.inference_step(hidden, jkv, position, **kw)
        got, out_kv = stub.inference_step(hidden, tkv, position, **kw)
        assert out_kv[0] is tkv[0] and got.shape == hidden.shape
        _close(got, want, TOL[use_flash])
        eager, _ = backend.inference_step(hidden, eager_kv, position, **kw)
        assert torch.equal(got, eager)
        assert all(torch.equal(a, b) for a, b in zip(tkv, eager_kv))
        position += hidden.shape[1]
    for got, want in zip(tkv, jkv):
        _close(got, want, TOL[use_flash])
    assert not tkv[0][:, :, position:].any()  # padded rows dropped
    # each key (bucket, hypo_ids, pre_seq): an eager call, then a capture
    # that replays, then replays
    keys = {}
    for hidden, kw in steps:
        seq = hidden.shape[1]
        key = (0 if seq == 1 else bucket_length(seq), "hypo_ids" in kw, "prompts" in kw)
        keys[key] = keys.get(key, 0) + 1
    calls = list(keys.values())
    want_counts = {"eager": len(calls), "captures": sum(n >= 2 for n in calls), "replays": sum(n - 1 for n in calls),
                   "anomalies": 0}
    assert _counts(stub, "_private_program") == want_counts
    assert obs.compile_stats()["anomalies"] == 0


# ------------------------------------------------------------------ device-scalar arms


@pytest.mark.parametrize("position,n_valid,seq", [(3, 5, 8), (0, 0, 8), (10, 4, 16), (28, 300, 512), (0, 1, 1), (380, 8, 8)])
def test_update_kv_cache_tensor_scalars_write_the_host_int_bytes(position, n_valid, seq):
    rng = np.random.default_rng(position + seq)
    buf = [torch.from_numpy(rng.standard_normal((2, MAXLEN, 2, 16)).astype(np.float32)) for _ in range(2)]
    k_new, v_new = (torch.from_numpy(rng.standard_normal((2, seq, 2, 16)).astype(np.float32)) for _ in range(2))
    by_tensor = [b.clone() for b in buf]
    sc = torch.tensor([position, n_valid], dtype=torch.int32)
    _, _, kv_len = update_kv_cache(by_tensor, k_new, v_new, sc[0], sc[1])
    n = min(n_valid, MAXLEN - position)  # rows past the buffer drop
    _, _, want_len = update_kv_cache(buf, k_new, v_new, position, n)
    assert all(torch.equal(a, b) for a, b in zip(by_tensor, buf))
    assert int(kv_len) == position + n_valid and want_len == position + n


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_reference_takes_tensor_scalars(name):
    (q, k, v), kw = _case(name)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    slopes = kw.get("alibi_slopes")
    tkw = {**kw, **({"alibi_slopes": torch.from_numpy(slopes)} if slopes is not None else {})}
    host = fa.flash_attend_reference(tq, tk, tv, **tkw)
    scalars = {name: torch.tensor(kw.get(name, dflt), dtype=torch.int32)
               for name, dflt in (("q_offset", 0), ("kv_length", k.shape[1]))}
    got = fa.flash_attend(tq, tk, tv, **{**tkw, **scalars})
    assert torch.equal(got, host)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **_jax_kwargs(kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


# ------------------------------------------------------------------ keys and counts


def test_dense_program_key_separates_what_a_graph_bakes_in():
    k, v = torch.zeros(2, 2, 32, 2, 16), torch.zeros(2, 2, 32, 2, 16)
    key = dense_program_key("dense", 8, "none", (k, v), False, 0)
    variants = [
        dense_program_key("dense", 8, "none", (k.clone(), v), False, 0),  # another cache
        dense_program_key("dense", 8, "none", (k[:, :1], v[:, :1]), False, 0),  # same address, batch 1
        dense_program_key("dense", 16, "none", (k, v), False, 0),  # another bucket
        dense_program_key("dense", 0, "none", (k, v), False, 0),  # a decode token
        dense_program_key("dense", 8, "none", (k, v), True, 0),  # hypo_ids
        dense_program_key("dense", 8, "none", (k, v), False, 5),  # deep prompts
        dense_program_key("dense", 8, "nf4a", (k, v), False, 0),  # the weights' encoding
        dense_program_key("dense", 8, "none", (k[:, :, :16], v[:, :, :16]), False, 0),  # a shorter cache
    ]
    assert len(set(variants + [key])) == len(variants) + 1
    assert key == dense_program_key("dense", 8, "none", (k, v), False, 0)


class FakeKernel:
    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        count_launch(self, "launches")
        return (x + 1,)


def test_non_steady_keys_capture_on_their_second_call_and_are_never_anomalies():
    obs, kernel = Observatory(), FakeKernel()
    steady = TrackedGraph("steady", StubCapture(), observatory=obs)
    private = TrackedGraph("private", OnceCapture(), steady=False, observatory=obs)
    (out,) = private.run("a", kernel, (torch.zeros(2),))  # eager: the launch counted at once
    assert torch.equal(out, torch.ones(2)) and kernel.launches == 1
    assert (private.counts.eager_calls, private.counts.captures, private.counts.replays) == (1, 0, 0)
    for i in range(3):
        (out,) = private.run("a", kernel, (torch.full((2,), float(i)),))
        assert torch.equal(out, torch.full((2,), i + 1.0))
    # one capture (no warm-up: the eager call was it), three replays, a launch each
    c = private.counts
    assert (c.calls, c.eager_calls, c.captures, c.replays, kernel.launches) == (4, 1, 1, 3, 4)
    for key in range(2 * DEFAULT_WARMUP_CALLS):  # keys that come and go: never an anomaly
        for _ in range(2):
            private.run(("k", key), kernel, (torch.zeros(2),))
    assert c.anomalies == 0 and c.captures == 1 + 2 * DEFAULT_WARMUP_CALLS
    assert private.drop(lambda key: key != "a") == 2 * DEFAULT_WARMUP_CALLS
    assert list(private._entries) == ["a"]
    private.run(("k", 0), kernel, (torch.zeros(2),))  # a dropped key starts over: eager
    assert c.eager_calls == 2 + 2 * DEFAULT_WARMUP_CALLS
    for _ in range(DEFAULT_WARMUP_CALLS + 1):
        steady.run("a", kernel, (torch.zeros(2),))
    steady.run("b", kernel, (torch.zeros(2),))  # a steady program's late capture
    assert (steady.counts.captures, steady.counts.anomalies, steady.counts.eager_calls) == (2, 1, 0)
    functions = {f["fn"]: f for f in obs.functions()}
    assert functions["private"]["eager_calls"] == c.eager_calls and functions["private"]["anomalies"] == 0


def test_freeing_a_private_cache_drops_its_graphs(model_path):
    """The handler's private cache context drops the cache's programs before
    the memory cache frees it; another cache's graphs stay."""
    jax_backend, backend = _backends(model_path)
    stub, _ = _stubbed(backend)
    rng = np.random.default_rng(1)
    hidden = (rng.standard_normal((2, 1, 64)) * 0.1).astype(np.float32)
    handler = types.SimpleNamespace(memory_cache=MemoryCache(None))
    other = tuple(d.make_zeros() for d in stub.cache_descriptors(2, 32, 0, N_LAYERS))
    for i in range(2):
        stub.inference_step(hidden, other, i)

    async def session():
        async with TransformerHandler._private_cache_ctx(handler, stub, 2, 32, None) as handles:
            kv = tuple(handler.memory_cache.get_buffers(*handles))
            for i in range(3):
                stub.inference_step(hidden, kv, i)
            return len(stub._private_program._entries)

    assert asyncio.run(session()) == 2
    assert len(stub._private_program._entries) == 1  # the freed cache's decode graph went
    assert not stub._private_program._seen - set(stub._private_program._entries)
    assert stub.drop_cache_programs(other) == 1 and not stub._private_program._entries


# ------------------------------------------------------------------ the dense pool


def _pool(backend, n_lanes, max_len, rng=None):
    shape = (backend.n_blocks, n_lanes, max_len, backend.num_kv_heads, backend.head_dim)
    if rng is None:
        return tuple(torch.zeros(shape) for _ in range(2))
    return tuple(torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(np.float32)) for _ in range(2))


def test_dense_pool_warmup_captures_every_program_and_serving_captures_none(model_path):
    """Warming a 2-lane pool captures the batched decode step, the
    generation step and the lane programs at bucket 0 and every bucket up
    to the longest chunk, writing nothing; a batcher then serving a chunked
    prefill, decode steps, a 1-token tail chunk and deep prompts captures
    no steady program, and its replies equal the eager backend's."""
    _, backend = _backends(model_path, span=(0, N_LAYERS))
    stub, obs = _stubbed(backend)
    params = load_client_params(model_path, device="cpu")
    queue = PriorityTaskQueue()
    queue.start()
    batcher = DecodeBatcher(stub, MemoryCache(None), queue, n_lanes=2, max_length=48, page_size=0)
    rng = np.random.default_rng(2)
    prompt = (rng.standard_normal((1, 21, 64)) * 0.1).astype(np.float32)
    tokens = [(rng.standard_normal((1, 1, 64)) * 0.1).astype(np.float32) for _ in range(3)]
    deep = (rng.standard_normal((N_LAYERS, 1, 4, 64)) * 0.1).astype(np.float32)

    def chunk(h, pos, **kw):
        def run(kv_lane):
            return stub.inference_step(h, kv_lane, pos, **kw)
        return run

    async def main():
        try:
            await batcher.ensure_open()
            pool = batcher._buffers()
            before = [t.clone() for t in pool]
            stub.warm_dense_programs(pool, 2, 48, 16, params)
            assert all(torch.equal(a, b) for a, b in zip(before, pool))
            warm = {attr: _counts(stub, attr)["captures"] for attr, _, steady in PROGRAMS if steady}
            lane = await batcher.acquire_lane(timeout=5)
            outs = await batcher.run_exclusive_chunks(
                lane, [chunk(prompt[:, :16], 0), chunk(prompt[:, 16:20], 16), chunk(prompt[:, 20:], 20)],
                write_range=(0, 21))
            got = [torch.cat(outs, dim=1)]
            for i, tok in enumerate(tokens):
                got.append(await batcher.step(lane, torch.from_numpy(tok), 21 + i))
            for i in range(2):  # the second exclusive op with prompts replays a private program
                got.append(await batcher.run_exclusive(lane, chunk(tokens[i], 24 + i, prompts=deep)))
            return warm, got, dict(batcher.stats)
        finally:
            await batcher.close()
            queue.shutdown()

    warm, got, stats = asyncio.run(asyncio.wait_for(main(), 120))
    n_buckets = 1 + len(chunk_buckets(16))  # bucket 0, then 8 and 16
    assert warm == {"_dense_decode_program": 1, "_dense_gen_program": 1, "_lane_program": 2 * n_buckets}
    for attr, _, steady in PROGRAMS:
        if steady:
            assert _counts(stub, attr)["captures"] == warm[attr] and _counts(stub, attr)["anomalies"] == 0
    assert _counts(stub, "_lane_program")["replays"] == 2 * n_buckets + 3  # warm-up, then the three chunks
    assert _counts(stub, "_private_program") == {"eager": 1, "captures": 1, "replays": 1, "anomalies": 0}
    assert stats["graph_anomalies"] == 0 and stats["batched_steps"] == 3
    # the same session on the eager backend's private cache
    kv = tuple(d.make_zeros() for d in backend.cache_descriptors(1, 48, 0, N_LAYERS))
    want = [backend.inference_step(prompt, kv, 0)[0]]
    for i, tok in enumerate(tokens):
        want.append(backend.inference_step(tok, kv, 21 + i)[0])
    for i in range(2):
        want.append(backend.inference_step(tokens[i], kv, 24 + i, prompts=deep)[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0)
    assert not stub._lane_program._entries and not stub._dense_decode_program._entries  # dropped at close


def test_lane_view_prefill_equals_extract_insert_and_jax(model_path):
    jax_backend, backend = _backends(model_path)
    stub, _ = _stubbed(backend)
    rng = np.random.default_rng(3)
    pool = _pool(backend, 3, 64, rng)
    copied = tuple(t.clone() for t in pool)
    stub.warm_dense_programs(pool, 3, 64, 32)
    lane_keys = len(stub._lane_program._entries)
    # lane 1 holds 10 rows of a session; a 19-token chunk continues it
    prompt = (rng.standard_normal((1, 19, 64)) * 0.1).astype(np.float32)
    view = stub.dense_lane_view(*pool, 1)
    got, _ = stub.inference_step(prompt, view, 10)
    assert len(stub._lane_program._entries) == lane_keys and _counts(stub, "_private_program")["eager"] == 0
    k, v = backend.lane_extract(*copied, 1)
    want, (k, v) = backend.inference_step(prompt, (k, v), 10)
    backend.lane_insert(*copied, k, v, 1)
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(pool, copied))
    jkv = tuple(jnp.asarray(t[:, 1:2].numpy()) for t in _pool(backend, 3, 64, np.random.default_rng(3)))
    jout, jkv = jax_backend.inference_step(prompt, jkv, 10)
    _close(got, jout, TOL[False])
    for t, j in zip(pool, jkv):
        _close(t[:, 1:2], j, TOL[False])


# ------------------------------------------------------------------ generation and forward


def _gen_backends(path):
    jax_backend, backend = _backends(path)
    jfamily, jcfg = jax_block_config(path)
    return (jax_backend, backend, jax_load_client(path, dtype=jnp.float32, family=jfamily, cfg=jcfg),
            load_client_params(path, device="cpu"))


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_generate_tokens_program_equals_petals_tpu(model_path, mode):
    """A 7-token prompt, then 12 tokens twice (the second chunk's steps all
    replay); tokens equal petals_tpu's, the caches within 2e-5 and bit-equal
    to the port's eager loop."""
    jb, pb, jparams, params = _gen_backends(model_path)
    stub, _ = _stubbed(pb)
    sampling = None if mode == "greedy" else {**SAMPLED, "offset": 2, "context": [4, 9, 9, 30]}
    prompt = np.random.default_rng(4).standard_normal((1, 7, 64)).astype(np.float32)
    jkv, pkv = _zeros(jb, pb, 1, 64)
    eager_kv = tuple(t.clone() for t in pkv)
    jout, jkv = jb.inference_step(prompt, jkv, 0)
    pout, _ = stub.inference_step(prompt, pkv, 0)
    eout, _ = pb.inference_step(prompt, eager_kv, 0)
    position, last, elast = 7, pout[:, -1:], eout[:, -1:]
    for _ in range(2):
        want, jkv = jb.generate_tokens(jparams, np.asarray(jout)[:, -1:], jkv, position, 12, sampling=sampling)
        got, _ = stub.generate_tokens(params, last, pkv, position, 12, sampling=sampling)
        eager, _ = pb.generate_tokens(params, elast, eager_kv, position, 12, sampling=sampling)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got, eager)
        assert all(torch.equal(a, b) for a, b in zip(pkv, eager_kv))
        # the last token is fed next, as a client would: its output seeds the next chunk
        feed = params["embed"][torch.from_numpy(got[:, -1:].astype(np.int64))].numpy()
        position += 11
        jout, jkv = jb.inference_step(feed, jkv, position)
        pout, _ = stub.inference_step(feed, pkv, position)
        eout, _ = pb.inference_step(feed, eager_kv, position)
        position += 1
        last, elast = pout, eout
    for g, w in zip(pkv, jkv):
        _close(g, w, TOL[False])
    assert _counts(stub, "_private_gen_program") == {"eager": 1, "captures": 1, "replays": 21, "anomalies": 0}


def test_batched_gen_decode_program_equals_petals_tpu(model_path):
    from petals_tpu.ops.sampling import sampling_vectors

    jb, pb, jparams, params = _gen_backends(model_path)
    stub, _ = _stubbed(pb)
    rng = np.random.default_rng(5)
    n_lanes, max_len = 4, 48
    rows = [_pool(pb, n_lanes, max_len, rng)[0].numpy() for _ in range(2)]
    pool = tuple(torch.from_numpy(r.copy()) for r in rows)
    eager = tuple(torch.from_numpy(r.copy()) for r in rows)
    stub.warm_dense_programs(pool, n_lanes, max_len, 8, params)
    hidden = (rng.standard_normal((n_lanes, 1, 64)) * 0.1).astype(np.float32)
    tokens, use_token = np.array([5, 0, 77, 0], np.int32), np.array([True, False, True, False])
    positions = np.array([9, 30, 17, max_len], np.int32)
    vec = sampling_vectors(n_lanes, pb.cfg.vocab_size)
    vec["do_sample"][2] = True
    vec["temperature"][2], vec["seeds"][2] = 0.7, 11
    jkv = tuple(jnp.asarray(r) for r in rows)
    for _ in range(2):
        want_h, want_tok, jkv = jb.batched_gen_decode_step(jparams, hidden, tokens, use_token, jkv, positions,
                                                           sampling_vecs=vec)
        got_h, got_tok, _ = stub.batched_gen_decode_step(params, hidden, tokens, use_token, pool, positions,
                                                         sampling_vecs=vec)
        e_h, e_tok, _ = pb.batched_gen_decode_step(params, hidden, tokens, use_token, eager, positions,
                                                   sampling_vecs=vec)
        np.testing.assert_array_equal(got_tok.numpy()[:3], np.asarray(want_tok)[:3])
        _close(got_h[:3], np.asarray(want_h)[:3], TOL[False])
        assert torch.equal(got_h, e_h) and torch.equal(got_tok, e_tok)
        tokens = got_tok.numpy().astype(np.int32) * use_token
        positions = positions + np.array([1, 1, 1, 0], np.int32)
        vec["draw_idx"] += 1
    for t, e, j in zip(pool, eager, jkv):
        assert torch.equal(t, e)
        _close(t, j, TOL[False])
    assert _counts(stub, "_dense_gen_program") == {"eager": 0, "captures": 1, "replays": 3, "anomalies": 0}


@pytest.mark.parametrize("with_prompts", [False, True])
def test_forward_program_equals_jax(model_path, with_prompts):
    jax_backend, backend = _backends(model_path)
    stub, _ = _stubbed(backend)
    rng = np.random.default_rng(6)
    hidden = (rng.standard_normal((2, 20, 64)) * 0.1).astype(np.float32)
    prompts = (rng.standard_normal((N_LAYERS, 2, 6, 64)) * 0.1).astype(np.float32) if with_prompts else None
    want = np.asarray(jax_backend.forward(hidden, prompts=prompts))
    eager = backend.forward(torch.from_numpy(hidden), prompts=None if prompts is None else torch.from_numpy(prompts))
    for _ in range(3):  # eager, captured, replayed
        got = stub.forward(torch.from_numpy(hidden), prompts=None if prompts is None else torch.from_numpy(prompts))
        _close(got, want, TOL[False])
        assert torch.equal(got, eager)
    assert _counts(stub, "_forward_program") == {"eager": 1, "captures": 1, "replays": 2, "anomalies": 0}
