"""The port's TransformerBackend steps against a JAX TransformerBackend on
the same weights, pools and tables (the scenario of
tests/test_mixed_batching.py test_paged_mixed_step_parity_direct): decode
lanes, the prefill chunk's output and the written KV rows, on identity and
permuted/oversubscribed tables, including a continuation chunk at a
non-zero position. Then the port's batcher: a prefill fed through the mixed
step equals one whole chunk, an exhausted pool raises AllocationFailed, and
a step failing on the device resets the pool and invalidates every lane.

Tolerance: atol 2e-5 in f32, as tests/test_mixed_batching.py uses."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops.paged_attention import identity_tables
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.memory_cache import AllocationFailed, MemoryCache
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.utils import make_tiny_mistral

TOL = 2e-5
N_BLOCKS = 2


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    # mistral: GQA and a 6-token window, so the window arm of both paths runs
    path = make_tiny_mistral(str(tmp_path_factory.mktemp("models")), n_layers=N_BLOCKS, window=6)
    jfamily, jcfg = jax_block_config(path)
    per_block = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(N_BLOCKS)]
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block)
    jax_backend = JaxBackend(
        jfamily, jcfg, jstacked, first_block=0, n_blocks=N_BLOCKS,
        memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
    )
    family, cfg = get_block_config(path)
    numpy_blocks = [jax.tree_util.tree_map(np.asarray, p) for p in per_block]
    backend = TransformerBackend(
        family, cfg, stacked_from_numpy(numpy_blocks, "cpu", torch.float32),
        first_block=0, n_blocks=N_BLOCKS, device="cpu", compute_dtype=torch.float32,
    )
    return jax_backend, backend, cfg


L, PS, MAX_PAGES = 3, 8, 6
MAXLEN = PS * MAX_PAGES


def _tables(layout, rng):
    if layout == "identity":
        return np.asarray(identity_tables(L, MAX_PAGES)), L * MAX_PAGES
    n_pages = 20  # oversubscribed: not every lane can hold max_length
    tables = np.full((L, MAX_PAGES), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane, need in enumerate((6, 20, 18)):  # tokens each lane will hold
        for s in range(-(-need // PS)):
            tables[lane, s] = free.pop()
    return tables, n_pages


def _pools(rng, cfg, n_pages):
    shape = (N_BLOCKS, n_pages, PS, cfg.num_key_value_heads, cfg.head_dim)
    return (rng.standard_normal(shape) * 0.5).astype(np.float32), (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("layout", ["identity", "permuted"])
def test_paged_decode_step_parity(backends, layout):
    jax_backend, backend, cfg = backends
    rng = np.random.default_rng(0)
    tables, n_pages = _tables(layout, rng)
    kp, vp = _pools(rng, cfg, n_pages)
    positions = np.array([5, MAXLEN, 17], np.int32)  # lane 1 idle at the sentinel
    hidden = (rng.standard_normal((L, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    want, (jk, jv) = jax_backend.paged_decode_step(hidden, (jnp.asarray(kp), jnp.asarray(vp)), positions, tables)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got, (k_out, _) = backend.paged_decode_step(hidden, (tk, tv), positions, tables)
    assert k_out is tk  # the pool is updated in place
    for lane in (0, 2):
        np.testing.assert_allclose(got.numpy()[lane], np.asarray(want)[lane], atol=TOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["identity", "permuted"])
def test_paged_mixed_step_parity(backends, layout):
    jax_backend, backend, cfg = backends
    rng = np.random.default_rng(1)
    tables, n_pages = _tables(layout, rng)
    kp, vp = _pools(rng, cfg, n_pages)
    positions = np.array([5, MAXLEN, 17], np.int32)  # lane 1 prefills
    hidden = (rng.standard_normal((L, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    prompt = (rng.standard_normal((1, 20, cfg.hidden_size)) * 0.1).astype(np.float32)
    split = 13  # chunk 1: [0, 13), then a continuation [13, 20)
    jpools = (jnp.asarray(kp), jnp.asarray(vp))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())

    want, want_c1, jpools = jax_backend.paged_mixed_step(hidden, jpools, positions, tables, prompt[:, :split], 1, 0)
    got, got_c1, _ = backend.paged_mixed_step(hidden, (tk, tv), positions, tables, prompt[:, :split], 1, 0)
    for lane in (0, 2):
        np.testing.assert_allclose(got.numpy()[lane], np.asarray(want)[lane], atol=TOL, rtol=0)
    np.testing.assert_allclose(got_c1.numpy(), np.asarray(want_c1), atol=TOL, rtol=0)

    idle = np.zeros((L, 1, cfg.hidden_size), np.float32)
    sentinel = np.full((L,), MAXLEN, np.int32)
    _, want_c2, jpools = jax_backend.paged_mixed_step(idle, jpools, sentinel, tables, prompt[:, split:], 1, split)
    _, got_c2, _ = backend.paged_mixed_step(idle, (tk, tv), sentinel, tables, prompt[:, split:], 1, split)
    np.testing.assert_allclose(got_c2.numpy(), np.asarray(want_c2), atol=TOL, rtol=0)
    # every KV row written (decode rows and the chunk's 20) agrees
    np.testing.assert_allclose(tk.numpy(), np.asarray(jpools[0]), atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jpools[1]), atol=TOL, rtol=0)


def test_chunk_plan_aligns_to_pages(backends):
    _, backend, _ = backends
    plan = backend.chunk_plan(1, 100, page_size=16, start=5)
    assert sum(plan) == 100
    assert all((5 + sum(plan[: i + 1])) % 16 == 0 for i in range(len(plan) - 1))


def test_batcher_prefill_lane_and_exhausted_pool(backends):
    """A prefill fed through the mixed step in budget-sized chunks equals
    one whole-prompt chunk; a lane whose pages the pool cannot supply gets
    AllocationFailed at its timeout, and the pool serves again afterwards."""
    _, backend, cfg = backends
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy((rng.standard_normal((1, 21, cfg.hidden_size)) * 0.1).astype(np.float32))

    async def main():
        queue = PriorityTaskQueue()
        queue.start()
        batcher = DecodeBatcher(
            backend, MemoryCache(None), queue, n_lanes=2, max_length=32, page_size=8,
            n_pages=5, prefill_token_budget=8, alloc_timeout=0.2,
        )
        try:
            lane = await batcher.acquire_lane(timeout=5)
            out = await batcher.prefill_lane(lane, prompt, 0)
            assert batcher.stats["mixed_steps"] == 3  # 8 + 8 + 5 tokens
            assert batcher.stats["max_prefill_tokens_per_step"] == 8
            # reference: one whole chunk on a fresh lane of a fresh pool
            ref_batcher = DecodeBatcher(
                backend, MemoryCache(None), queue, n_lanes=1, max_length=32, page_size=8,
                prefill_token_budget=64,
            )
            ref_lane = await ref_batcher.acquire_lane(timeout=5)
            want = await ref_batcher.prefill_lane(ref_lane, prompt, 0)
            np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL, rtol=0)
            # lane 0 holds 3 of the 5 pages; a second lane wanting 3 more fails
            other = await batcher.acquire_lane(timeout=5)
            with pytest.raises(AllocationFailed):
                await batcher.prefill_lane(other, prompt, 0)
            batcher.release_lane(lane)
            await batcher.prefill_lane(other, prompt, 0)  # pages freed: it fits now
        finally:
            await batcher.close()
            queue.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))


def test_batcher_device_failure_resets_the_pool(backends):
    """A step that fails on the device (a RuntimeError) zeroes the pool and
    bumps the generation: the failed step's waiter gets the error, every
    other outstanding lane fails loudly on its next step, and a fresh lane
    serves again from the zeroed pool."""
    _, backend, cfg = backends
    rng = np.random.default_rng(3)
    token = torch.from_numpy((rng.standard_normal((1, 1, cfg.hidden_size)) * 0.1).astype(np.float32))
    prompt = torch.from_numpy((rng.standard_normal((1, 5, cfg.hidden_size)) * 0.1).astype(np.float32))

    class FailingOnce:
        def __init__(self, inner):
            self.inner, self.fail = inner, True

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def paged_decode_step(self, *args):
            if self.fail:
                self.fail = False
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return self.inner.paged_decode_step(*args)

    async def main():
        queue = PriorityTaskQueue()
        queue.start()
        batcher = DecodeBatcher(
            FailingOnce(backend), MemoryCache(None), queue, n_lanes=2, max_length=32, page_size=8,
        )
        try:
            a = await batcher.acquire_lane(timeout=5)
            b = await batcher.acquire_lane(timeout=5)
            await batcher.prefill_lane(b, prompt, 0)
            k_pool, _ = batcher._buffers()
            assert k_pool.abs().sum() > 0
            with pytest.raises(RuntimeError, match="illegal memory access"):
                await batcher.step(a, token, 0)
            assert batcher.stats["pool_resets"] == 1
            assert k_pool.abs().sum() == 0  # zeroed in place
            with pytest.raises(AllocationFailed, match="reset"):
                await batcher.step(b, token, 5)
            batcher.release_lane(a)
            batcher.release_lane(b)
            fresh = await batcher.acquire_lane(timeout=5)
            out = await batcher.prefill_lane(fresh, prompt, 0)
            assert torch.isfinite(out).all() and out.shape == prompt.shape
        finally:
            await batcher.close()
            queue.shutdown()

    asyncio.run(asyncio.wait_for(main(), 60))
