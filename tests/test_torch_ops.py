"""The port's primitives (petals_tpu_torch.models.common, ops.rotary,
ops.attention, ops.paged_attention) against the JAX package's, on the same
numpy inputs, on the CPU.

Tolerances: elementwise f32 ops and attention agree to atol 1e-5 (sums
taken in another order); the page scatters are copies and must be
bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.models import common as jcommon
from petals_tpu.ops import attention as jattention
from petals_tpu.ops import paged_attention as jpaged
from petals_tpu.ops import rotary as jrotary
from petals_tpu_torch.models import common as tcommon
from petals_tpu_torch.ops import attention as tattention
from petals_tpu_torch.ops import paged_attention as tpaged
from petals_tpu_torch.ops import rotary as trotary

ATOL = 1e-5

LLAMA3_SCALING = {
    "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
    "high_freq_factor": 4.0, "original_max_position_embeddings": 64,
}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_rms_norm_and_silu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    close(tcommon.rms_norm(t(x), t(w), 1e-6), jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    close(tcommon.silu(t(x)), jcommon.silu(jnp.asarray(x)))


LINEAR_SCALING = {"rope_type": "linear", "factor": 2.0}


@pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING, LINEAR_SCALING], ids=["plain", "llama3", "linear"])
def test_rotary(scaling):
    rng = np.random.default_rng(1)
    positions = rng.integers(0, 300, size=(2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    cos_t, sin_t = trotary.rotary_tables(t(positions), 32, theta=10000.0, rope_scaling=scaling)
    cos_j, sin_j = jrotary.rotary_tables(jnp.asarray(positions), 32, theta=10000.0, rope_scaling=scaling)
    close(cos_t, cos_j)
    close(sin_t, sin_j)
    close(
        trotary.apply_rotary(t(x), cos_t, sin_t),
        jrotary.apply_rotary(jnp.asarray(x), cos_j, sin_j),
    )


@pytest.mark.parametrize("window", [None, 6])
def test_attend_reference_ragged_and_scalar(window):
    rng = np.random.default_rng(2)
    hq, hkv, d, skv = 8, 2, 16, 20
    # ragged vector positions (continuous batching decode)
    q = rng.standard_normal((3, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((3, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((3, skv, hkv, d)).astype(np.float32)
    pos = np.array([0, 5, 19], np.int32)
    got = tattention.attend_reference(
        t(q), t(k), t(v), q_offset=t(pos), kv_length=t(pos + 1), sliding_window=window
    )
    want = jattention.attend_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=jnp.asarray(pos), kv_length=jnp.asarray(pos + 1), sliding_window=window,
    )
    close(got, want)
    # scalar offset, a 4-row chunk, with ALiBi slopes
    q4 = rng.standard_normal((3, 4, hq, d)).astype(np.float32)
    slopes = (rng.standard_normal(hq) * 0.1).astype(np.float32)
    got = tattention.attend_reference(
        t(q4), t(k), t(v), q_offset=9, kv_length=13, sliding_window=window, alibi_slopes=t(slopes)
    )
    want = jattention.attend_reference(
        jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v), q_offset=9, kv_length=13,
        sliding_window=window, alibi_slopes=jnp.asarray(slopes),
    )
    close(got, want)


# ------------------------------------------------------------ page scatters

N_LANES, MAX_PAGES, PS, HKV, D = 3, 4, 4, 2, 8
N_PAGES = 14
MAX_LEN = MAX_PAGES * PS


def _layouts():
    rng = np.random.default_rng(3)
    identity = np.asarray(jpaged.identity_tables(N_LANES, MAX_PAGES))
    permuted = rng.permutation(N_PAGES)[: N_LANES * MAX_PAGES].astype(np.int32).reshape(N_LANES, MAX_PAGES)
    holey = permuted.copy()
    holey[0, 2:] = -1
    holey[1, 1:] = -1
    holey[2, 3] = -1
    return {"identity": (identity, N_LANES * MAX_PAGES), "permuted": (permuted, N_PAGES),
            "holey": (holey, N_PAGES)}


LAYOUTS = _layouts()


def _pool(rng, n_pages):
    return rng.standard_normal((n_pages, PS, HKV, D)).astype(np.float32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scatter_token_rows_identical(layout):
    tables, n_pages = LAYOUTS[layout]
    rng = np.random.default_rng(4)
    pool = _pool(rng, n_pages)
    rows = rng.standard_normal((N_LANES, HKV, D)).astype(np.float32)
    # lane 1 idle at the sentinel; lane 0 in slot 2, a hole in the holey layout
    positions = np.array([9, MAX_LEN, 13], np.int32)
    want = jpaged.scatter_token_rows(jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(tables), jnp.asarray(positions))
    got = t(pool.copy())
    tpaged.scatter_token_rows(got, t(rows), t(tables), t(positions))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scatter_chunk_rows_identical(layout):
    tables, n_pages = LAYOUTS[layout]
    rng = np.random.default_rng(5)
    pool = _pool(rng, n_pages)
    rows = rng.standard_normal((7, HKV, D)).astype(np.float32)
    # five real rows from position 3, two padded rows routed one past the lane
    positions = np.array([3, 4, 5, 6, 7, MAX_LEN, MAX_LEN], np.int32)
    for lane in range(N_LANES):
        want = jpaged.scatter_chunk_rows(
            jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(tables[lane]), jnp.asarray(positions)
        )
        got = t(pool.copy())
        tpaged.scatter_chunk_rows(got, t(rows), t(tables[lane]), t(positions))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"lane {lane}")


def test_dropped_writes_leave_the_pool_untouched():
    """Sentinel and padded rows must drop: with no valid row at all, no byte
    of the pool changes (page 0 and the last page included)."""
    tables, n_pages = LAYOUTS["permuted"]
    rng = np.random.default_rng(6)
    pool = _pool(rng, n_pages)
    got = t(pool.copy())
    rows = rng.standard_normal((N_LANES, HKV, D)).astype(np.float32)
    tpaged.scatter_token_rows(got, t(rows), t(tables), t(np.full(N_LANES, MAX_LEN, np.int32)))
    tpaged.scatter_chunk_rows(got, t(rows), t(tables[0]), t(np.array([MAX_LEN, -1, MAX_LEN + 5], np.int32)))
    np.testing.assert_array_equal(got.numpy(), pool)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_paged_update_kv_decode_and_chunk(layout):
    tables, n_pages = LAYOUTS[layout]
    rng = np.random.default_rng(7)
    kp, vp = _pool(rng, n_pages), _pool(rng, n_pages)
    # decode branch: [n_lanes] positions, one row per lane
    k_new = rng.standard_normal((N_LANES, 1, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((N_LANES, 1, HKV, D)).astype(np.float32)
    positions = np.array([2, MAX_LEN, 14], np.int32)
    jk, jv, jlen = jpaged.paged_update_kv(
        jpaged.PagedKV(jnp.asarray(kp), jnp.asarray(tables)),
        jpaged.PagedKV(jnp.asarray(vp), jnp.asarray(tables)),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(positions),
    )
    tk, tv = t(kp.copy()), t(vp.copy())
    _, _, tlen = tpaged.paged_update_kv(
        tpaged.PagedKV(tk, t(tables)), tpaged.PagedKV(tv, t(tables)),
        t(k_new), t(v_new), t(positions),
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk.pool))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.pool))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    # scalar-chunk branch: 6 rows at position 5 of which 4 are real
    k_new = rng.standard_normal((1, 6, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((1, 6, HKV, D)).astype(np.float32)
    row = tables[2:3]
    jk, jv, jlen = jpaged.paged_update_kv(
        jpaged.PagedKV(jnp.asarray(kp), jnp.asarray(row)),
        jpaged.PagedKV(jnp.asarray(vp), jnp.asarray(row)),
        jnp.asarray(k_new), jnp.asarray(v_new), 5, n_valid=4,
    )
    tk, tv = t(kp.copy()), t(vp.copy())
    _, _, tlen = tpaged.paged_update_kv(
        tpaged.PagedKV(tk, t(row)), tpaged.PagedKV(tv, t(row)), t(k_new), t(v_new), 5, n_valid=4
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk.pool))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.pool))
    assert int(tlen) == int(jlen) == 9


def test_gather_pages_zeroes_unallocated_slots():
    tables, n_pages = LAYOUTS["holey"]
    rng = np.random.default_rng(8)
    pool = _pool(rng, n_pages)
    got = tpaged.gather_pages(t(pool), t(tables)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpaged.gather_pages(jnp.asarray(pool), jnp.asarray(tables))))
    np.testing.assert_array_equal(got[0, 2 * PS :], 0.0)
