"""Dense-cache serving in the port against the JAX package on the CPU (f32):

- ``TransformerBackend.inference_step`` on a dense cache against a JAX
  ``TransformerBackend`` with ``use_flash`` False (XLA attention) and True
  (the Pallas flash kernel in interpret mode, cache length 128): prefill,
  chunked by a small ``max_chunk_size_bytes``, decode, batch 2, deep prompts,
  ``hypo_ids``; replies and the whole caches are compared.
- ``batched_decode_step`` on a dense lane pool with sentinel lanes.
- ``lane_extract`` / ``lane_insert`` and the paged gather / scatter of one
  lane, float, int8 and nf4a pools: byte-identical to the JAX package's.
- The batcher's dense mode, its exclusive ops on both pools, and the
  failed-chunk check-in of ``run_exclusive_chunks``.
- A port ``Server`` with ``page_size=0``, and private batch-2 and sub-span
  sessions, driven by the JAX package's ``RpcClient``: replies equal a JAX
  backend's and greedy tokens equal a ``petals_tpu`` server's.
- ``--page_size 0 --kv_quant_type int8`` raises in both packages.

Tolerance: atol 2e-5 in f32 against XLA attention (tests/test_mixed_batching.py)
and 1e-4 where the JAX side runs the Pallas kernel in interpret mode (its
online softmax sums in another order; two blocks deep). Arrays from JAX are
copied before the port sees them: it writes caches in place."""

import asyncio
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.ops import paged_attention as J
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.client import RpcError
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.memory_cache import AllocationFailed, MemoryCache
from petals_tpu_torch.server.server import Server, default_dht_prefix
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.utils.convert import dense_cache_from_numpy, stacked_from_numpy, tensor_from_numpy
from tests.utils import make_tiny_mistral

TOL = {False: 2e-5, True: 1e-4}  # by the JAX side's use_flash
N_BLOCKS = 3
MAXLEN = 128  # a multiple of 128, so the JAX flash kernel takes the cache

jax_quantize = jax.jit(J.quantize_kv_rows, static_argnums=1)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    # mistral: GQA and a 6-token window, so the window arm of every path runs
    return make_tiny_mistral(str(tmp_path_factory.mktemp("models")), n_layers=N_BLOCKS, window=6)


@pytest.fixture(scope="module")
def make_backends(model_path):
    jfamily, jcfg = jax_block_config(model_path)
    per_block = [jax_load_block(model_path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(N_BLOCKS)]
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block)
    family, cfg = get_block_config(model_path)
    numpy_blocks = [jax.tree_util.tree_map(np.asarray, p) for p in per_block]
    cache = {}

    def make(use_flash: bool, max_chunk_size_bytes: int = 256 * 2**20, kv_quant_type: str = "none"):
        key = (use_flash, max_chunk_size_bytes, kv_quant_type)
        if key not in cache:
            jax_backend = JaxBackend(
                jfamily, jcfg, jstacked, first_block=0, n_blocks=N_BLOCKS, memory_cache=JaxMemoryCache(None),
                compute_dtype=jnp.float32, use_flash=use_flash, max_chunk_size_bytes=max_chunk_size_bytes,
                kv_quant_type=kv_quant_type,
            )
            backend = TransformerBackend(
                family, cfg, stacked_from_numpy(numpy_blocks, "cpu", torch.float32),
                first_block=0, n_blocks=N_BLOCKS, device="cpu", compute_dtype=torch.float32,
                use_flash=use_flash, max_chunk_size_bytes=max_chunk_size_bytes, kv_quant_type=kv_quant_type,
            )
            cache[key] = (jax_backend, backend, cfg)
        return cache[key]

    return make


def _zeros(jax_backend, backend, batch, max_length=MAXLEN):
    kd, vd = jax_backend.cache_descriptors(batch, max_length, 0, N_BLOCKS)
    td = backend.cache_descriptors(batch, max_length, 0, N_BLOCKS)
    assert tuple(td[0].shape) == tuple(kd.shape) == (N_BLOCKS, batch, max_length, 2, 16)
    return (kd.make_zeros(), vd.make_zeros()), tuple(d.make_zeros() for d in td)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want), atol=tol, rtol=0)


# ----------------------------------------------------------- inference_step


def _steps(case, rng, hsz):
    """The steps of one session: (hidden, kwargs) each."""
    def h(batch, seq):
        return (rng.standard_normal((batch, seq, hsz)) * 0.1).astype(np.float32)

    if case == "prefill_decode":
        return 1, [(h(1, 20), {}), (h(1, 1), {}), (h(1, 1), {}), (h(1, 9), {}), (h(1, 1), {})]
    if case == "batch2":
        return 2, [(h(2, 17), {}), (h(2, 1), {}), (h(2, 8), {}), (h(2, 3), {})]
    if case == "deep_prompts":
        prompts = (rng.standard_normal((N_BLOCKS, 2, 5, hsz)) * 0.1).astype(np.float32)
        # the second step's chunk [3, 14) still overlaps the prompts' [0, 5)
        return 2, [(h(2, 3), {"prompts": prompts}), (h(2, 11), {"prompts": prompts}), (h(2, 1), {"prompts": prompts})]
    if case == "hypo_ids":
        return 3, [(h(3, 12), {}), (h(3, 1), {"hypo_ids": np.array([2, 0, 0], np.int32)}),
                   (h(3, 8), {"hypo_ids": np.array([1, 1, 2], np.int32)}), (h(3, 1), {})]
    raise KeyError(case)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("case", ["prefill_decode", "batch2", "deep_prompts", "hypo_ids"])
def test_inference_step_matches_jax(make_backends, case, use_flash):
    jax_backend, backend, cfg = make_backends(use_flash)
    batch, steps = _steps(case, np.random.default_rng(0), cfg.hidden_size)
    jkv, tkv = _zeros(jax_backend, backend, batch)
    position = 0
    for hidden, kw in steps:
        want, jkv = jax_backend.inference_step(hidden, jkv, position, **kw)
        got, out_kv = backend.inference_step(hidden, tkv, position, **kw)
        assert out_kv[0] is tkv[0] and out_kv[1] is tkv[1]  # written in place
        _close(got, want, TOL[use_flash])
        position += hidden.shape[1]
    _close(tkv[0], jkv[0], TOL[use_flash])
    _close(tkv[1], jkv[1], TOL[use_flash])
    assert tkv[0][:, :, position:].abs().sum() == 0  # nothing written past the session


@pytest.mark.parametrize("use_flash", [False, True])
def test_inference_step_chunked_by_max_chunk_size_bytes(make_backends, use_flash):
    """A 40-token prefill at batch 2 under a chunk bound that forces several
    chunks (4 heads x 40 positions x 4 bytes x batch 2 a row: 11 rows a chunk
    on the quadratic rule) equals the JAX package's and the unchunked one."""
    bound = 2 * 4 * 40 * 4 * 11
    jax_backend, backend, cfg = make_backends(use_flash, bound)
    assert backend.chunk_plan(2, 40) == [11, 11, 11, 7]
    if not use_flash:  # the JAX flash rule sizes chunks by activations instead
        assert list(jax_backend.chunk_plan(2, 40, kv_buf_len=MAXLEN)) == [11, 11, 11, 7]
    rng = np.random.default_rng(1)
    hidden = (rng.standard_normal((2, 40, cfg.hidden_size)) * 0.1).astype(np.float32)
    jkv, tkv = _zeros(jax_backend, backend, 2)
    want, jkv = jax_backend.inference_step(hidden, jkv, 0)
    got, _ = backend.inference_step(hidden, tkv, 0, n_total=40)
    _close(got, want, TOL[use_flash])
    _close(tkv[0], jkv[0], TOL[use_flash])
    _close(tkv[1], jkv[1], TOL[use_flash])
    _, whole, _ = make_backends(use_flash)
    _, wkv = _zeros(jax_backend, whole, 2)
    unchunked, _ = whole.inference_step(hidden, wkv, 0)
    _close(got, unchunked.numpy(), 2e-5)


def test_inference_step_validates(make_backends):
    _, backend, cfg = make_backends(False)
    _, tkv = _zeros(*make_backends(False)[:2], 1, 16)
    hidden = np.zeros((1, 10, cfg.hidden_size), np.float32)
    with pytest.raises(ValueError, match="overflows"):
        backend.inference_step(hidden, tkv, 7)
    with pytest.raises(ValueError, match="n_total"):
        backend.inference_step(hidden, tkv, 0, n_total=9)
    with pytest.raises(ValueError, match="does not match"):
        backend.inference_step(np.zeros((2, 4, cfg.hidden_size), np.float32), tkv, 0)
    assert backend.use_flash is False and make_backends(True)[1].use_flash is True
    default = TransformerBackend(backend.family, cfg, backend.block_params, first_block=0, n_blocks=N_BLOCKS,
                                 device="cpu", compute_dtype=torch.float32)
    assert default.use_flash is False  # on by default on a CUDA device only


# ----------------------------------------------------------- the dense lane pool


def _dense_pool(rng, cfg, n_lanes, max_len):
    shape = (N_BLOCKS, n_lanes, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return tuple((rng.standard_normal(shape) * 0.5).astype(np.float32) for _ in range(2))


def test_batched_decode_step_matches_jax(make_backends):
    jax_backend, backend, cfg = make_backends(False)
    rng = np.random.default_rng(2)
    n_lanes, max_len = 4, 24
    kp, vp = _dense_pool(rng, cfg, n_lanes, max_len)
    positions = np.array([5, max_len, 17, 0], np.int32)  # lane 1 idles at the sentinel
    hidden = (rng.standard_normal((n_lanes, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    want, (jk, jv) = jax_backend.batched_decode_step(hidden, (jnp.asarray(kp), jnp.asarray(vp)), positions)
    tk, tv = dense_cache_from_numpy((kp, vp), "cpu")
    got, (k_out, _) = backend.batched_decode_step(hidden, (tk, tv), positions)
    assert k_out is tk
    for lane in (0, 2, 3):
        _close(got[lane], np.asarray(want)[lane], 2e-5)
    _close(tk, jk, 2e-5)
    _close(tv, jv, 2e-5)
    assert np.array_equal(tk[:, 1].numpy(), kp[:, 1])  # the idle lane's write dropped
    # every lane idle: nothing is written at all
    before = tk.clone()
    backend.batched_decode_step(hidden, (tk, tv), np.full((n_lanes,), max_len, np.int32))
    assert torch.equal(tk, before)


def test_update_kv_cache_per_lane_drops_like_jax(make_backends):
    """Per-lane writes of several rows with n_valid and out-of-range positions
    against the JAX package's scatter with mode="drop"."""
    from petals_tpu.models.common import update_kv_cache as jax_update
    from petals_tpu_torch.models.common import update_kv_cache

    rng = np.random.default_rng(3)
    k_buf, v_buf = rng.standard_normal((2, 3, 10, 2, 4)).astype(np.float32)
    k_new, v_new = rng.standard_normal((2, 3, 4, 2, 4)).astype(np.float32)
    pos = np.array([0, 8, 10], np.int32)  # lane 1 overruns the buffer by 2 rows, lane 2 is idle
    for n_valid in (None, 3):
        jk, jv, jlen = jax_update((jnp.asarray(k_buf), jnp.asarray(v_buf)), jnp.asarray(k_new), jnp.asarray(v_new),
                                  jnp.asarray(pos), n_valid)
        tk, tv = dense_cache_from_numpy((k_buf, v_buf), "cpu")
        k_all, v_all, tlen = update_kv_cache((tk, tv), torch.from_numpy(k_new), torch.from_numpy(v_new),
                                             torch.from_numpy(pos), n_valid)
        assert k_all is tk and v_all is tv
        assert np.array_equal(tk.numpy(), np.asarray(jk)) and np.array_equal(tv.numpy(), np.asarray(jv))
        assert np.array_equal(tlen.numpy(), np.asarray(jlen))


def test_lane_extract_and_insert_match_jax(make_backends):
    jax_backend, backend, cfg = make_backends(False)
    rng = np.random.default_rng(4)
    kp, vp = _dense_pool(rng, cfg, 3, 16)
    jk, jv = jax_backend._lane_extract_fn(jnp.asarray(kp), jnp.asarray(vp), np.int32(1))
    tk, tv = dense_cache_from_numpy((kp, vp), "cpu")
    k, v = backend.lane_extract(tk, tv, 1)
    assert np.array_equal(k.numpy(), np.asarray(jk)) and np.array_equal(v.numpy(), np.asarray(jv))
    k.add_(1.0)  # a copy: the pool does not move
    assert np.array_equal(tk.numpy(), kp)
    jk2, jv2 = jax_backend._lane_insert_fn(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k.numpy()), jv, np.int32(2))
    backend.lane_insert(tk, tv, k, v, 2)
    assert np.array_equal(tk.numpy(), np.asarray(jk2)) and np.array_equal(tv.numpy(), np.asarray(jv2))


def _span_pools(rng, kind, cfg, n_pages, ps):
    """(JAX pools, port pools) of a span, holding the same bytes."""
    shape = (N_BLOCKS, n_pages, ps, cfg.num_key_value_heads, cfg.head_dim)
    jpools, tpools = [], []
    for _ in range(2):
        rows = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        if kind == "none":
            jpools.append(jnp.asarray(rows))
            tpools.append(tensor_from_numpy(rows, "cpu", None))
        else:
            codes, scales = jax_quantize(jnp.asarray(rows), kind)
            jpools.append(J.PagedPool(codes, scales))
            tpools.append(T.PagedPool(tensor_from_numpy(np.asarray(codes), "cpu", None),
                                      tensor_from_numpy(np.asarray(scales), "cpu", None)))
    return jpools, tpools


def _same_pool(tpool, jpool):
    if isinstance(tpool, T.PagedPool):
        return (np.array_equal(tpool.codes.numpy(), np.asarray(jpool.codes))
                and np.array_equal(tpool.scales.numpy(), np.asarray(jpool.scales)))
    return np.array_equal(tpool.numpy(), np.asarray(jpool))


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_paged_lane_gather_and_scatter_match_jax(make_backends, kind):
    """One lane gathered out of the pages through a table row with holes, then
    a computed-on buffer scattered back: the same bytes as the JAX package's
    (a quantized pool decoded on the way out and re-encoded on the way in)."""
    jax_backend, backend, cfg = make_backends(False, kv_quant_type=kind)
    rng = np.random.default_rng(5)
    ps, max_pages, n_pages = 8, 4, 9
    jpools, tpools = _span_pools(rng, kind, cfg, n_pages, ps)
    row = np.array([7, 2, -1, -1], np.int32)
    jk, jv = jax_backend._paged_lane_gather_fn(jpools[0], jpools[1], row)
    k, v = backend.paged_lane_gather(tpools[0], tpools[1], row)
    assert tuple(k.shape) == (N_BLOCKS, 1, max_pages * ps, cfg.num_key_value_heads, cfg.head_dim)
    assert np.array_equal(k.float().numpy(), np.asarray(jk, np.float32))
    assert np.array_equal(v.float().numpy(), np.asarray(jv, np.float32))
    assert not k[:, :, 2 * ps:].any()  # holes read as zeros
    # compute on the lane (new rows at [10, 14)), then check it back in
    new_rows = (rng.standard_normal((N_BLOCKS, 1, 4, cfg.num_key_value_heads, cfg.head_dim)) * 0.5).astype(np.float32)
    k[:, :, 10:14] = torch.from_numpy(new_rows).to(k.dtype)
    jk = jk.at[:, :, 10:14].set(jnp.asarray(new_rows, jk.dtype))
    jk_pool, jv_pool = jax_backend._paged_lane_scatter_fn(jpools[0], jpools[1], jk, jv, row)
    backend.paged_lane_scatter(tpools[0], tpools[1], k, v, row)
    assert _same_pool(tpools[0], jk_pool) and _same_pool(tpools[1], jv_pool)
    # an all-hole row writes nothing
    before = [p.codes.clone() if isinstance(p, T.PagedPool) else p.clone() for p in tpools]
    backend.paged_lane_scatter(tpools[0], tpools[1], k, v, np.full((max_pages,), -1, np.int32))
    after = [p.codes if isinstance(p, T.PagedPool) else p for p in tpools]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


# ----------------------------------------------------------- the batcher


def _batcher(backend, queue, page_size, **kw):
    return DecodeBatcher(backend, MemoryCache(None), queue, n_lanes=2, max_length=32, page_size=page_size, **kw)


@pytest.mark.parametrize("page_size", [None, 8])
def test_batcher_exclusive_ops_and_decode(make_backends, page_size):
    """A lane prefilled through run_exclusive_chunks (two chunks, each its own
    queue task), stepped through the coalesced decode step, then given deep
    prompts through run_exclusive, on the dense pool and on the paged one:
    every reply equals the JAX backend's on a private cache."""
    jax_backend, backend, cfg = make_backends(False)
    rng = np.random.default_rng(6)
    hsz = cfg.hidden_size
    prompt = (rng.standard_normal((1, 13, hsz)) * 0.1).astype(np.float32)
    tokens = [(rng.standard_normal((1, 1, hsz)) * 0.1).astype(np.float32) for _ in range(3)]
    deep = (rng.standard_normal((N_BLOCKS, 1, 20, hsz)) * 0.1).astype(np.float32)
    tail = (rng.standard_normal((1, 2, hsz)) * 0.1).astype(np.float32)

    def chunk_fn(chunk, pos, **kw):
        def run(kv_lane):
            out, kv_lane = backend.inference_step(chunk, kv_lane, pos, **kw)
            return out, kv_lane
        return run

    async def main():
        queue = PriorityTaskQueue()
        queue.start()
        batcher = _batcher(backend, queue, page_size)
        try:
            other = await batcher.acquire_lane(timeout=5)
            lane = await batcher.acquire_lane(timeout=5)
            assert (other, lane) == (0, 1)
            outs = await batcher.run_exclusive_chunks(
                lane, [chunk_fn(prompt[:, :8], 0), chunk_fn(prompt[:, 8:], 8)], size=13, write_range=(0, 13))
            assert batcher.stats["exclusive_chunks"] == 2
            got = [torch.cat(outs, dim=1)]
            for i, tok in enumerate(tokens):
                got.append(await batcher.step(lane, torch.from_numpy(tok), 13 + i))
            assert batcher.stats["batched_steps"] == 3 and batcher.stats["mixed_steps"] == 0
            got.append(await batcher.run_exclusive(lane, chunk_fn(tail, 16, prompts=deep), size=2, write_range=(16, 18)))
            # the other lane was never written
            k_pool, _ = batcher._buffers()
            if page_size is None:
                assert tuple(k_pool.shape) == (N_BLOCKS, 2, 32, 2, 16) and not k_pool[:, other].any()
                assert batcher.n_pages == 0 and batcher._tables is None
            return got
        finally:
            await batcher.close()
            queue.shutdown()

    got = asyncio.run(asyncio.wait_for(main(), 120))
    jkv, _ = _zeros(jax_backend, backend, 1, 32)
    position = 0
    for hidden, kw, out in zip([prompt] + tokens + [tail], [{}] * 4 + [{"prompts": deep}], got):
        want, jkv = jax_backend.inference_step(hidden, jkv, position, **kw)
        _close(out, want, 2e-5)
        position += hidden.shape[1]


@pytest.mark.parametrize("page_size", [None, 8])
def test_run_exclusive_chunks_checks_the_lane_in_after_a_failed_chunk(make_backends, page_size):
    """The second of three chunks fails: the error reaches the caller, the
    lane is checked back in with the first chunk's rows, no pool reset
    happens (not a device failure), and the session can redo the prefill."""
    jax_backend, backend, cfg = make_backends(False)
    rng = np.random.default_rng(7)
    prompt = (rng.standard_normal((1, 12, cfg.hidden_size)) * 0.1).astype(np.float32)

    def chunk_fn(lo, hi, fail=False):
        def run(kv_lane):
            if fail:
                raise ValueError("chunk refused")
            return backend.inference_step(prompt[:, lo:hi], kv_lane, lo)
        return run

    async def main():
        queue = PriorityTaskQueue()
        queue.start()
        batcher = _batcher(backend, queue, page_size)
        try:
            lane = await batcher.acquire_lane(timeout=5)
            with pytest.raises(ValueError, match="chunk refused"):
                await batcher.run_exclusive_chunks(
                    lane, [chunk_fn(0, 4), chunk_fn(4, 8, fail=True), chunk_fn(8, 12)], write_range=(0, 12))
            assert batcher.stats["exclusive_chunks"] == 1 and batcher.stats["pool_resets"] == 0
            k_lane, _ = batcher._extract_lane(lane)
            assert k_lane[:, :, :4].abs().sum() > 0 and not k_lane[:, :, 4:].any()  # chunk 1 was checked in
            outs = await batcher.run_exclusive_chunks(
                lane, [chunk_fn(0, 4), chunk_fn(4, 8), chunk_fn(8, 12)], write_range=(0, 12))
            # a lane released mid-prefill is not written into: the check-in is skipped
            batcher.release_lane(lane)
            with pytest.raises(AllocationFailed):
                await batcher.run_exclusive(lane, chunk_fn(0, 4))
            return torch.cat(outs, dim=1)
        finally:
            await batcher.close()
            queue.shutdown()

    got = asyncio.run(asyncio.wait_for(main(), 120))
    jkv, _ = _zeros(jax_backend, backend, 1, 32)
    want, _ = jax_backend.inference_step(prompt, jkv, 0)
    _close(got, want, 2e-5)


def test_dense_batcher_refuses_a_quantized_pool(make_backends):
    _, backend, _ = make_backends(False, kv_quant_type="int8")
    with pytest.raises(ValueError, match="paged pool"):
        DecodeBatcher(backend, MemoryCache(None), PriorityTaskQueue(), n_lanes=2, max_length=32, page_size=None)


# ----------------------------------------------------------- servers


def _uids(model_path, start=0, end=N_BLOCKS):
    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(start, end))


async def _session(client, uids, max_length, batch_size, steps):
    """Open a session, send the steps ((hidden, extra tensors) each) and
    return the replies' hidden states and step_meta variants."""
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": max_length, "batch_size": batch_size})
    assert (await stream.recv(timeout=60))["session_open"]
    outs, variants, position = [], [], 0
    for hidden, extra in steps:
        tensors = {"hidden": serialize_array(hidden), **{k: serialize_array(v) for k, v in extra.items()}}
        await stream.send({"tensors": tensors})
        reply = await stream.recv(timeout=120)
        position += hidden.shape[1]
        assert reply["position"] == position
        outs.append(deserialize_array(reply["tensors"]["hidden"]))
        variants.append(reply["step_meta"]["variant"])
    await stream.end()
    return outs, variants


def _port_server(model_path, page_size, **kw):
    return Server(
        model_path, first_block=0, num_blocks=N_BLOCKS, device="cpu", compute_dtype=torch.float32,
        batch_lanes=2, batch_max_length=64, page_size=page_size, prefill_token_budget=16, throughput=1.0, **kw,
    )


def _started(server):
    """``server`` after one start and shutdown: ``start()`` loads its span."""

    async def cycle():
        await server.start()
        await server.shutdown()

    asyncio.run(cycle())
    return server


def _jax_reference(make_backends, start, end):
    """A JAX backend over blocks [start, end) of the model (XLA attention)."""
    jax_backend, _, _ = make_backends(False)
    if (start, end) == (0, N_BLOCKS):
        return jax_backend
    return JaxBackend(
        jax_backend.family, jax_backend.cfg, jax_backend._slice_params(start, end), first_block=start,
        n_blocks=end - start, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
    )


SESSIONS = {
    # name: (page_size, (start, end), batch, max_length, expected variants)
    "dense_pool_lane": (0, (0, N_BLOCKS), 1, 64, ["dense_prefill", "decode", "decode", "exclusive", "dense_prefill"]),
    "paged_lane_exclusive": (16, (0, N_BLOCKS), 1, 64, ["prefill", "decode", "decode", "exclusive", "prefill"]),
    "private_batch2": (16, (0, N_BLOCKS), 2, 64, ["private"] * 5),
    "private_sub_span": (16, (1, 3), 1, 64, ["private"] * 5),
    "private_long_max_length": (0, (0, N_BLOCKS), 1, 100, ["private"] * 5),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_port_server_sessions_match_jax_backend(model_path, make_backends, name):
    """Each kind of session the open rule tells apart, over the wire of the
    JAX package's client: a 20-token prefill, two tokens, a 3-token step with
    deep prompts and hypo_ids, a 9-token continuation. Replies equal the JAX
    backend's on a private cache; step_meta names the path taken."""
    page_size, (start, end), batch, max_length, variants = SESSIONS[name]
    rng = np.random.default_rng(8)
    hsz = 64

    def h(seq):
        return (rng.standard_normal((batch, seq, hsz)) * 0.1).astype(np.float32)

    deep = (rng.standard_normal((end - start, batch, 30, hsz)) * 0.1).astype(np.float32)
    hypo = np.arange(batch, dtype=np.int32)[::-1].copy()
    steps = [(h(20), {}), (h(1), {}), (h(1), {}), (h(3), {"prompts": deep, "hypo_ids": hypo}), (h(9), {})]

    async def main():
        server = _port_server(model_path, page_size)
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            result = await _session(client, _uids(model_path, start, end), max_length, batch, steps)
            info = await client.call("ptu.info", {}, timeout=10)
            return result, info, dict(server.batcher.stats), server.memory_cache.bytes_left
        finally:
            await client.close()
            await server.shutdown()

    (outs, got_variants), info, stats, bytes_left = asyncio.run(asyncio.wait_for(main(), 180))
    assert got_variants == variants
    assert info["continuous_batching"]["page_size"] == (page_size or None)
    if name == "dense_pool_lane":
        assert stats["exclusive_chunks"] >= 0 and stats["batched_steps"] == 2 and stats["mixed_steps"] == 0
    ref = _jax_reference(make_backends, start, end)
    kd, vd = ref.cache_descriptors(batch, max_length, 0, end - start)
    jkv, position = (kd.make_zeros(), vd.make_zeros()), 0
    for (hidden, extra), out in zip(steps, outs):
        want, jkv = ref.inference_step(hidden, jkv, position, **extra)
        _close(out, want, 2e-5)
        position += hidden.shape[1]


def test_dense_pool_prefill_interleaves_chunks(model_path):
    """With a chunk bound that splits the prompt, the dense pool's prefill
    runs as separate queue tasks (``exclusive_chunks``), and a session that
    finds no free lane falls back to a private cache."""
    async def main():
        server = _port_server(model_path, 0, max_chunk_size_bytes=4 * 40 * 4 * 16)  # 16 rows a chunk
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            rng = np.random.default_rng(9)
            hidden = (rng.standard_normal((1, 40, 64)) * 0.1).astype(np.float32)
            held = []
            for _ in range(2):  # take both lanes
                stream = await client.open_stream("ptu.inference")
                await stream.send({"uids": _uids(model_path), "max_length": 64, "batch_size": 1})
                assert (await stream.recv(timeout=60))["session_open"]
                held.append(stream)
            await held[0].send({"tensors": {"hidden": serialize_array(hidden)}})
            reply = await held[0].recv(timeout=120)
            assert reply["step_meta"]["variant"] == "dense_prefill"
            chunks = server.batcher.stats["exclusive_chunks"]
            third = await client.open_stream("ptu.inference")
            await third.send({"uids": _uids(model_path), "max_length": 64, "batch_size": 1, "alloc_timeout": 0.2})
            assert (await third.recv(timeout=60))["session_open"]
            await third.send({"tensors": {"hidden": serialize_array(hidden)}})
            private = await third.recv(timeout=120)
            for stream in held + [third]:
                await stream.end()
            return chunks, reply, private
        finally:
            await client.close()
            await server.shutdown()

    chunks, reply, private = asyncio.run(asyncio.wait_for(main(), 180))
    assert chunks == 3  # 16 + 16 + 8 tokens
    assert private["step_meta"]["variant"] == "private"
    np.testing.assert_allclose(deserialize_array(private["tensors"]["hidden"]),
                               deserialize_array(reply["tensors"]["hidden"]), atol=2e-5, rtol=0)


def test_adapters_refused_and_server_gen_limited_to_whole_model_batch_1(model_path):
    """Adapters are refused; server-side generation is served to a
    whole-model session of batch 1 only (tests/test_torch_server_gen.py),
    so a batch-2 session's ``gen_tokens`` gets petals_tpu's refusal; a step
    of the wrong batch is refused by the step validation."""

    async def main():
        server = _port_server(model_path, 0)
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            base = {"uids": _uids(model_path), "max_length": 64, "batch_size": 2}
            stream = await client.open_stream("ptu.inference")
            await stream.send({**base, "active_adapter": "lora"})
            with pytest.raises(RpcError, match="not supported by this server yet"):
                await stream.recv(timeout=60)
            stream = await client.open_stream("ptu.inference")
            await stream.send(base)
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": serialize_array(np.zeros((2, 2, 64), np.float32))}, "gen_tokens": 4})
            with pytest.raises(RpcError, match="server-side generation is not available for this session"):
                await stream.recv(timeout=60)
            stream = await client.open_stream("ptu.inference")
            await stream.send(base)
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": serialize_array(np.zeros((1, 2, 64), np.float32))}})
            with pytest.raises(RpcError, match="batch=2"):  # _validate_step_tensors
                await stream.recv(timeout=60)
            await asyncio.sleep(0.1)
            assert server.memory_cache.bytes_left == server.memory_cache.max_size_bytes  # private caches freed
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 120))


def _rms(x, w, eps):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * w


async def _greedy(client, uids, head, prompts, n_new, max_length):
    """Greedy loop at batch len(prompts) over raw ptu.inference steps;
    embeddings, final norm and LM head applied here from the checkpoint."""
    embed, norm_w, lm_head, eps = head
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": max_length, "batch_size": len(prompts)})
    await stream.recv(timeout=60)
    tokens = [list(p) for p in prompts]
    hidden = embed[np.asarray(tokens)]
    for _ in range(n_new):
        await stream.send({"tensors": {"hidden": serialize_array(hidden.astype(np.float32))}})
        out = deserialize_array((await stream.recv(timeout=120))["tensors"]["hidden"])
        logits = _rms(out[:, -1].astype(np.float32), norm_w, eps) @ lm_head.T
        new = np.argmax(logits, axis=-1)
        for row, tok in zip(tokens, new):
            row.append(int(tok))
        hidden = embed[new][:, None]
    await stream.end()
    return [row[len(p):] for row, p in zip(tokens, prompts)]


GREEDY = {
    # name: (page_size of both servers, (start, end), prompts, max_length)
    "dense_pool": (0, (0, N_BLOCKS), [[3, 17, 42, 5, 99, 7, 7, 21, 4]], 48),
    "private_batch2": (16, (0, N_BLOCKS), [[3, 17, 42, 5, 99, 1, 2, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2, 1]], 48),
    "private_sub_span": (16, (1, 3), [[3, 17, 42, 5, 99, 11, 12, 13, 14, 15]], 48),
}


@pytest.mark.parametrize("name", sorted(GREEDY))
def test_greedy_tokens_match_jax_server(model_path, name):
    """8 greedy tokens from a port server equal a petals_tpu server's with
    the same settings: a dense-pool lane, a private batch-2 session and a
    sub-span session (whose logits are those of a shorter stack)."""
    page_size, (start, end), prompts, max_length = GREEDY[name]
    weights = load_file(os.path.join(model_path, "model.safetensors"))
    _, cfg = jax_block_config(model_path)
    head = (weights["model.embed_tokens.weight"], weights["model.norm.weight"], weights["lm_head.weight"], cfg.rms_norm_eps)
    uids = _uids(model_path, start, end)

    async def main():
        server = _port_server(model_path, page_size)
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            port_tokens = await _greedy(client, uids, head, prompts, 8, max_length)
        finally:
            await client.close()
            await server.shutdown()
        jserver = JaxServer(
            model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
            batching=True, batch_lanes=2, batch_max_length=64, page_size=page_size,
            prefix_cache_bytes=0, prefix_device_bytes=0, server_side_generation=False,
        )
        await jserver.start()
        jclient = await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)
        try:
            jax_tokens = await _greedy(jclient, uids, head, prompts, 8, max_length)
        finally:
            await jclient.close()
            await jserver.shutdown()
        return port_tokens, jax_tokens

    port_tokens, jax_tokens = asyncio.run(asyncio.wait_for(main(), 300))
    assert all(len(row) == 8 for row in port_tokens)
    assert port_tokens == jax_tokens


def test_page_size_0_with_a_quantized_pool_raises_in_both_packages(model_path, tmp_path, monkeypatch):
    from petals_tpu_torch.cli.run_server import build_parser, build_server

    with pytest.raises(ValueError, match="requires the paged KV pool"):
        _port_server(model_path, 0, kv_quant_type="int8")
    with pytest.raises(ValueError, match="requires the paged KV pool"):
        JaxServer(model_path, compute_dtype=jnp.float32, throughput=1.0, page_size=0, kv_quant_type="int8")
    base = [model_path, "--first_block", "0", "--num_blocks", "2", "--device", "cpu", "--dtype", "float32"]
    with pytest.raises(ValueError, match="requires the paged KV pool"):
        build_server(build_parser().parse_args(base + ["--page_size", "0", "--kv_quant_type", "int8"]))
    monkeypatch.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path))  # the measured throughput's cache
    server = _started(build_server(build_parser().parse_args(base + ["--page_size", "0"])))
    assert server.batcher.page_size is None and server.batcher.n_pages == 0
    assert (server.batcher.n_lanes, server.batcher.max_length) == (4, 1024)  # half the budget in lanes
