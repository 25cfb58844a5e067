"""The plain versions of the two paged-attention kernels
(petals_tpu_torch.ops.paged_attention paged_attend / paged_prefill_attend,
which the kernel wrappers take for CPU tensors) against the JAX package's
Pallas kernels run in interpret mode, over the cases of
tests/test_paged_kernel.py: identity and ragged, permuted and holey tables
(holes only past each lane's frontier), GQA 1/2/4/8, ALiBi, sliding windows,
chunked prefill at chunk_pos 0 and > 0 with n_valid < chunk.

Tolerance: atol 2e-5 in f32, as tests/test_paged_kernel.py uses (the
kernel's online softmax sums in another order than the one-shot softmax).

tests/test_torch_kernels_cuda.py holds the CUDA kernels against the same
plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops.paged_attention import identity_tables
from petals_tpu.ops.paged_flash_attention import (
    paged_flash_attend as jax_decode,
    paged_flash_prefill_attend as jax_prefill,
)
from petals_tpu_torch.ops import paged_flash_attention as pfa
from petals_tpu_torch.ops.paged_attention import PagedKV, paged_attend, paged_prefill_attend

TOL = 2e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand_pool(rng, n_pages, ps, hkv, d):
    return (
        rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32),
        rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32),
    )


def _holey_permuted(rng, n_lanes, max_pages, n_pages, used_slots):
    """A permuted table where lane l keeps only its first used_slots[l]
    slots allocated; the rest are -1 holes past its frontier."""
    tables = np.full((n_lanes, max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane in range(n_lanes):
        for s in range(used_slots[lane]):
            tables[lane, s] = free.pop()
    return tables


def _check_decode(q, kp, vp, tables, pos, **kw):
    want = jax_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(pos),
        interpret=True, **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()},
    )
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = paged_attend(t(q), t(kp), t(vp), t(tables), t(pos), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    wrapped = pfa.paged_flash_attend(t(q), t(kp), t(vp), t(tables), t(pos), **tkw)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    return got


def test_decode_identity_and_ragged():
    rng = np.random.default_rng(0)
    n_lanes, max_pages, ps, hkv, group, d = 4, 4, 16, 2, 2, 32
    kp, vp = _rand_pool(rng, n_lanes * max_pages, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    tables = np.asarray(identity_tables(n_lanes, max_pages))
    pos = np.array([0, ps - 1, 2 * ps, 3 * ps + 5], np.int32)  # 0, page edges, mid-page
    _check_decode(q, kp, vp, tables, pos)


def test_decode_permuted_and_holey():
    rng = np.random.default_rng(1)
    n_lanes, max_pages, ps, hkv, group, d = 3, 4, 8, 2, 4, 16
    kp, vp = _rand_pool(rng, 20, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    pos = np.array([3 * ps - 1, 2 * ps - 1, ps], np.int32)
    tables = _holey_permuted(rng, n_lanes, max_pages, 20, [-(-int(p + 1) // ps) for p in pos])
    _check_decode(q, kp, vp, tables, pos)


def test_holes_past_the_frontier_never_matter():
    """Pointing the -1 slots past each lane's frontier at a live page of
    another tenant must give BIT-identical output."""
    rng = np.random.default_rng(2)
    n_lanes, max_pages, ps, hkv, group, d = 2, 4, 8, 2, 2, 16
    kp, vp = _rand_pool(rng, 16, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    pos = np.array([ps + 3, 2 * ps - 1], np.int32)
    holey = _holey_permuted(rng, n_lanes, max_pages, 16, [2, 2])
    garbage = holey.copy()
    garbage[garbage < 0] = 15
    out_holey = pfa.paged_flash_attend(t(q), t(kp), t(vp), t(holey), t(pos))
    out_garbage = pfa.paged_flash_attend(t(q), t(kp), t(vp), t(garbage), t(pos))
    np.testing.assert_array_equal(out_holey.numpy(), out_garbage.numpy())


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_decode_gqa_ratios(group):
    rng = np.random.default_rng(3)
    hq, n_lanes, max_pages, ps, d = 8, 2, 3, 8, 16
    hkv = hq // group
    kp, vp = _rand_pool(rng, n_lanes * max_pages, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hq, d)).astype(np.float32)
    perm = rng.permutation(n_lanes * max_pages).astype(np.int32).reshape(n_lanes, max_pages)
    _check_decode(q, kp, vp, perm, np.array([2 * ps, 3 * ps - 1], np.int32))


@pytest.mark.parametrize("window", [None, 5, 20])
def test_decode_alibi_and_window(window):
    rng = np.random.default_rng(4)
    n_lanes, max_pages, ps, hkv, group, d = 3, 4, 8, 2, 2, 16
    kp, vp = _rand_pool(rng, n_lanes * max_pages, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    perm = rng.permutation(n_lanes * max_pages).astype(np.int32).reshape(n_lanes, max_pages)
    pos = np.array([0, 2 * ps - 1, 4 * ps - 1], np.int32)
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    _check_decode(q, kp, vp, perm, pos, alibi_slopes=slopes, sliding_window=window)


@pytest.mark.parametrize(
    "chunk_pos,n_valid,window",
    [(0, 24, None), (8, 17, None), (8, 17, 9), (16, 5, None), (0, 0, None)],
)
def test_prefill_parity(chunk_pos, n_valid, window):
    rng = np.random.default_rng(5)
    max_pages, ps, hkv, group, d, chunk = 6, 8, 2, 4, 16, 24
    kp, vp = _rand_pool(rng, 12, ps, hkv, d)
    q = rng.standard_normal((1, chunk, hkv * group, d)).astype(np.float32)
    trow = _holey_permuted(rng, 1, max_pages, 12, [5])[0]
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    want = jax_prefill(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(trow),
        jnp.int32(chunk_pos), jnp.int32(n_valid),
        alibi_slopes=jnp.asarray(slopes), sliding_window=window, interpret=True,
    )
    got = paged_prefill_attend(
        t(q), t(kp), t(vp), t(trow), chunk_pos, n_valid,
        alibi_slopes=t(slopes), sliding_window=window,
    )
    # rows past n_valid are computed but never read: compare the real rows
    np.testing.assert_allclose(got.numpy()[:, :n_valid], np.asarray(want)[:, :n_valid], atol=TOL, rtol=0)
    wrapped = pfa.paged_flash_prefill_attend(
        t(q), t(kp), t(vp), t(trow), chunk_pos, n_valid,
        alibi_slopes=t(slopes), sliding_window=window,
    )
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_dispatch_routes_by_position_rank():
    """``attend`` on a PagedKV: a [n_lanes] position vector is decode, a
    scalar is one lane's chunk with kv_length - q_offset valid rows."""
    from petals_tpu_torch.ops.attention import attend

    rng = np.random.default_rng(6)
    ps, hkv, d = 8, 2, 16
    kp, vp = _rand_pool(rng, 8, ps, hkv, d)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    q = rng.standard_normal((2, 1, 4, d)).astype(np.float32)
    pos = np.array([5, 20], np.int32)
    got = attend(t(q), PagedKV(t(kp), t(tables)), PagedKV(t(vp), t(tables)), q_offset=t(pos), kv_length=t(pos + 1))
    np.testing.assert_array_equal(got.numpy(), paged_attend(t(q), t(kp), t(vp), t(tables), t(pos)).numpy())
    qc = rng.standard_normal((1, 6, 4, d)).astype(np.float32)
    got = attend(
        t(qc), PagedKV(t(kp), t(tables[1:])), PagedKV(t(vp), t(tables[1:])), q_offset=10, kv_length=14
    )
    want = paged_prefill_attend(t(qc), t(kp), t(vp), t(tables[1]), 10, 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrappers_refuse_mixed_devices():
    q = torch.zeros(1, 1, 4, 16)
    pool = torch.zeros(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError):
        pfa.paged_flash_attend(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
