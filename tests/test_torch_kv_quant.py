"""The port's quantized paged KV pool (``--kv_quant_type int8|nf4a``) against
the JAX package, on the CPU, over the cases of tests/test_kv_quant.py.

- Codec: the port's ``quantize_kv_rows`` gives the codes and scales of the
  JAX package's JITTED encoder, byte for byte, for float32 and bfloat16 rows
  whose scales spread over 5 decades. Jitted, because that is what a JAX
  server's pool holds: XLA turns the encoder's ``/ 127.0`` into a
  multiplication by float32(1/127), where the same function run op by op
  divides. ``dequantize_kv`` is bit-equal to the JAX package's.
- Writes: ``paged_update_kv`` on PagedPools (decode with sentinel lanes and
  holes, a chunk with n_valid < chunk) leaves byte-identical codes and
  scales; ``gather_pages`` reads holes as zeros.
- The plain version of K3 (``paged_attend`` / ``paged_prefill_attend`` on
  PagedPools) against the JAX XLA twin (atol 2e-5 in f32: both decode the
  same codes to bfloat16 first) and against the Pallas kernels in interpret
  mode (KERNEL_TOL as tests/test_kv_quant.py: the kernel decodes to float32
  registers, the twins to bfloat16, so values differ by up to a bfloat16
  rounding); the wrappers on CPU tensors equal the plain versions.
- Backend, server and CLI: see each test.
"""

import asyncio
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from petals_tpu.ops import paged_attention as J
from petals_tpu.ops.paged_flash_attention import paged_flash_attend as jax_kernel_decode
from petals_tpu.ops.paged_flash_attention import paged_flash_prefill_attend as jax_kernel_prefill
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.ops import paged_flash_attention as pfa
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.utils import make_tiny_llama, make_tiny_mistral

KINDS = ("int8", "nf4a")
# max |x - decode(encode(x))| over the row's absmax (tests/test_kv_quant.py)
RT_BOUND = {"int8": 0.005, "nf4a": 0.145}
TWIN_TOL = 2e-5
KERNEL_TOL = 2e-2

jax_quantize = jax.jit(J.quantize_kv_rows, static_argnums=1)


def t(a):
    """A torch copy: np.asarray of a JAX array may share its buffer, and the
    port writes its pools in place."""
    return torch.from_numpy(np.array(a))


def _spread_rows(rng, shape):
    """Gaussian rows whose per-row scales spread over 5 decades, one row zero."""
    rows = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 2, (*shape[:-1], 1))
    rows[0] = 0.0
    return rows.astype(np.float32)


def _pools(rng, kind, n_pages, ps, hkv, d):
    """A (k, v) pair of quantized pools, as (JAX PagedPool, port PagedPool)
    pairs holding the same bytes."""
    out = []
    for _ in range(2):
        codes, scales = jax_quantize(jnp.asarray(rng.standard_normal((n_pages, ps, hkv, d)), jnp.float32), kind)
        out.append((J.PagedPool(codes, scales), T.PagedPool(t(np.asarray(codes)), t(np.asarray(scales)))))
    return out


def _holey_permuted(rng, n_lanes, max_pages, n_pages, used_slots):
    tables = np.full((n_lanes, max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane in range(n_lanes):
        for s in range(used_slots[lane]):
            tables[lane, s] = free.pop()
    return tables


def _assert_pools_equal(jpool, tpool):
    np.testing.assert_array_equal(tpool.codes.numpy(), np.asarray(jpool.codes))
    np.testing.assert_array_equal(tpool.scales.numpy(), np.asarray(jpool.scales))


# ------------------------------------------------------------------ codec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_codec_is_byte_identical_to_jax(kind, dtype):
    rng = np.random.default_rng(0)
    rows = _spread_rows(rng, (96, 4, 32))
    jrows, trows = jnp.asarray(rows), t(rows)
    if dtype == "bfloat16":
        jrows, trows = jrows.astype(jnp.bfloat16), trows.to(torch.bfloat16)
    jcodes, jscales = jax_quantize(jrows, kind)
    codes, scales = T.quantize_kv_rows(trows, kind)
    assert codes.dtype == (torch.int8 if kind == "int8" else torch.uint8)
    assert codes.shape == tuple(jcodes.shape) and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))  # bit-equal
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(J.dequantize_kv(jcodes, jscales, kind, jdt).astype(jnp.float32))
        got = T.dequantize_kv(codes, scales, kind, tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_scale_is_absmax_times_the_reciprocal():
    """The int8 scale is absmax * float32(1/127), the jitted encoder's bits
    (a true division gives other bits on some rows)."""
    rng = np.random.default_rng(1)
    rows = _spread_rows(rng, (4096, 16))
    _, scales = T.quantize_kv_rows(t(rows), "int8")
    absmax = np.maximum(np.abs(rows).max(-1), np.float32(1e-8))
    np.testing.assert_array_equal(scales.numpy(), absmax * (np.float32(1) / np.float32(127)))


def test_nf4a_bucketize_equals_counting_midpoints():
    """One bucketize gives the code the JAX encoder builds from 15
    comparisons, values on a midpoint exactly included."""
    rng = np.random.default_rng(2)
    mids = T._NF4A_MIDPOINTS
    normed = np.concatenate([rng.uniform(-1, 1, 4000), mids, np.nextafter(mids, 2), [-1.0, 1.0, 0.0]])
    normed = normed.astype(np.float32)
    counted = sum((normed > m).astype(np.uint8) for m in mids.tolist())
    got = torch.bucketize(t(normed), t(mids), out_int32=True).numpy()
    np.testing.assert_array_equal(got, counted)


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_error_bound_and_zero_rows(kind):
    rng = np.random.default_rng(3)
    rows = _spread_rows(rng, (64, 4, 16))
    codes, scales = T.quantize_kv_rows(t(rows), kind)
    deq = T.dequantize_kv(codes, scales, kind, torch.float32).double().numpy()
    absmax = np.abs(rows.astype(np.float64)).max(axis=-1, keepdims=True)
    rel = np.abs(deq - rows) / np.maximum(absmax, 1e-8)
    assert rel.max() <= RT_BOUND[kind], rel.max()
    # a zero row decodes to exact zeros: nf4a stores a zero scale, int8 zero
    # codes (its scale is floored at 1e-8 / 127, as in the JAX package)
    assert (deq[0] == 0).all()
    assert scales[0].eq(0).all() if kind == "nf4a" else codes[0].eq(0).all()


# ------------------------------------------------------------------ writes


def _jax_update(k_pool, v_pool, tables, k_new, v_new, position, n_valid=None):
    fn = jax.jit(
        lambda kp, vp, tb, kn, vn, pos: J.paged_update_kv(J.PagedKV(kp, tb), J.PagedKV(vp, tb), kn, vn, pos, n_valid)
    )
    k_kv, v_kv, _ = fn(k_pool, v_pool, jnp.asarray(tables), jnp.asarray(k_new), jnp.asarray(v_new),
                       jnp.asarray(position))
    return k_kv.pool, v_kv.pool


@pytest.mark.parametrize("kind", KINDS)
def test_decode_write_is_byte_identical(kind):
    rng = np.random.default_rng(4)
    n_lanes, max_pages, ps, hkv, d, n_pages = 4, 4, 8, 2, 16, 20
    (jk, tk), (jv, tv) = _pools(rng, kind, n_pages, ps, hkv, d)
    # lane 2 idles at the sentinel; lane 3's slot is a hole: both drop
    positions = np.array([5, 17, max_pages * ps, 9], np.int32)
    tables = _holey_permuted(rng, n_lanes, max_pages, n_pages, [1, 3, 4, 1])
    k_new, v_new = (_spread_rows(rng, (n_lanes, 1, hkv, d)) for _ in range(2))
    want_k, want_v = _jax_update(jk, jv, tables, k_new, v_new, positions)
    kv_len = T.paged_update_kv(T.PagedKV(tk, t(tables)), T.PagedKV(tv, t(tables)), t(k_new), t(v_new), t(positions))[2]
    assert kv_len.tolist() == (positions + 1).tolist()
    _assert_pools_equal(want_k, tk)
    _assert_pools_equal(want_v, tv)
    assert not np.array_equal(np.asarray(want_k.codes), np.asarray(jk.codes))  # something was written


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_write_is_byte_identical(kind):
    rng = np.random.default_rng(5)
    max_pages, ps, hkv, d, n_pages, chunk = 6, 8, 2, 16, 12, 16
    (jk, tk), (jv, tv) = _pools(rng, kind, n_pages, ps, hkv, d)
    tables = _holey_permuted(rng, 1, max_pages, n_pages, [4])
    k_new, v_new = (_spread_rows(rng, (1, chunk, hkv, d)) for _ in range(2))
    want_k, want_v = _jax_update(jk, jv, tables, k_new, v_new, 11, n_valid=13)  # 11 + 13 = 24: the rest drop
    kv_len = T.paged_update_kv(T.PagedKV(tk, t(tables)), T.PagedKV(tv, t(tables)), t(k_new), t(v_new), 11, 13)[2]
    assert kv_len == 24
    _assert_pools_equal(want_k, tk)
    _assert_pools_equal(want_v, tv)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_pages_reads_holes_as_zeros(kind):
    rng = np.random.default_rng(6)
    n_pages, ps, hkv, d = 4, 4, 1, 8
    rows = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32) + 3.0
    codes, scales = jax_quantize(jnp.asarray(rows), kind)
    jpool, tpool = J.PagedPool(codes, scales), T.PagedPool(t(np.asarray(codes)), t(np.asarray(scales)))
    assert tpool.shape == tuple(jpool.shape) == (n_pages, ps, hkv, d)
    assert tpool.dtype == torch.bfloat16 and tpool.nbytes == jpool.nbytes
    assert T.PagedKV(tpool, t(np.zeros((2, 3), np.int32))).shape == (2, 3 * ps, hkv, d)
    tables = np.array([[2, -1], [-1, -1]], np.int32)
    dense = T.gather_pages(tpool, t(tables))
    assert dense.dtype == torch.bfloat16 and dense.shape == (2, 2 * ps, hkv, d)
    want = J.gather_pages(jpool, jnp.asarray(tables)).astype(jnp.float32)
    np.testing.assert_array_equal(dense.float().numpy(), np.asarray(want))
    assert dense[0, ps:].eq(0).all() and dense[1].eq(0).all() and dense[0, :ps].ne(0).any()


# ------------------------------------------------------------------ plain K3


def _check_decode(kind, q, pools, tables, pos, **kw):
    (jk, tk), (jv, tv) = pools
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos))
    twin = np.asarray(J.paged_attend(*jargs, **jkw))
    kernel = np.asarray(jax_kernel_decode(*jargs, interpret=True, **jkw))
    got = T.paged_attend(t(q), tk, tv, t(tables), t(pos), **tkw)
    np.testing.assert_allclose(got.numpy(), twin, atol=TWIN_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), kernel, atol=KERNEL_TOL, rtol=0)
    wrapped = pfa.paged_flash_attend(t(q), tk, tv, t(tables), t(pos), **tkw)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_plain_decode_identity_tables(kind):
    rng = np.random.default_rng(7)
    n_lanes, max_pages, ps, hkv, group, d = 4, 4, 16, 2, 2, 32
    pools = _pools(rng, kind, n_lanes * max_pages, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    tables = J.identity_tables(n_lanes, max_pages)
    _check_decode(kind, q, pools, tables, np.array([0, ps - 1, 2 * ps, 3 * ps + 5], np.int32))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group", [1, 2, 4])
def test_plain_decode_permuted_holey_gqa(kind, group):
    rng = np.random.default_rng(8)
    hq, n_lanes, max_pages, ps, d, n_pages = 8, 3, 4, 8, 16, 20
    pools = _pools(rng, kind, n_pages, ps, hq // group, d)
    q = rng.standard_normal((n_lanes, 1, hq, d)).astype(np.float32)
    pos = np.array([3 * ps - 1, 2 * ps - 1, ps], np.int32)
    tables = _holey_permuted(rng, n_lanes, max_pages, n_pages, [-(-int(p + 1) // ps) for p in pos])
    _check_decode(kind, q, pools, tables, pos)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", [None, 7])
def test_plain_decode_alibi_window(kind, window):
    rng = np.random.default_rng(9)
    n_lanes, max_pages, ps, hkv, group, d = 3, 4, 8, 2, 2, 16
    pools = _pools(rng, kind, n_lanes * max_pages, ps, hkv, d)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    perm = rng.permutation(n_lanes * max_pages).astype(np.int32).reshape(n_lanes, max_pages)
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    _check_decode(kind, q, pools, perm, np.array([0, 2 * ps - 1, 4 * ps - 1], np.int32),
                  alibi_slopes=slopes, sliding_window=window)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("chunk_pos,n_valid,window", [(0, 24, None), (8, 17, 9)])
def test_plain_prefill(kind, chunk_pos, n_valid, window):
    rng = np.random.default_rng(10)
    max_pages, ps, hkv, group, d, chunk, n_pages = 6, 8, 2, 4, 16, 24, 12
    (jk, tk), (jv, tv) = _pools(rng, kind, n_pages, ps, hkv, d)
    q = rng.standard_normal((1, chunk, hkv * group, d)).astype(np.float32)
    trow = _holey_permuted(rng, 1, max_pages, n_pages, [5])[0]
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(trow), jnp.int32(chunk_pos), jnp.int32(n_valid))
    jkw = dict(alibi_slopes=jnp.asarray(slopes), sliding_window=window)
    twin = np.asarray(J.paged_prefill_attend(*jargs, **jkw))[:, :n_valid]
    kernel = np.asarray(jax_kernel_prefill(*jargs, interpret=True, **jkw))[:, :n_valid]
    targs = (t(q), tk, tv, t(trow), chunk_pos, n_valid)
    got = T.paged_prefill_attend(*targs, alibi_slopes=t(slopes), sliding_window=window)
    np.testing.assert_allclose(got.numpy()[:, :n_valid], twin, atol=TWIN_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy()[:, :n_valid], kernel, atol=2 * KERNEL_TOL, rtol=0)
    wrapped = pfa.paged_flash_prefill_attend(*targs, alibi_slopes=t(slopes), sliding_window=window)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


def test_attend_routes_a_quantized_paged_kv():
    """``attend`` on a PagedKV whose pool is a PagedPool routes exactly as
    on a plain pool; the CPU path counts no kernel launch."""
    from petals_tpu_torch.ops.attention import attend

    rng = np.random.default_rng(11)
    (_, tk), (_, tv) = _pools(rng, "nf4a", 8, 8, 2, 16)
    tables = t(np.arange(8, dtype=np.int32).reshape(2, 4))
    q = t(rng.standard_normal((2, 1, 4, 16)).astype(np.float32))
    pos = t(np.array([5, 20], np.int32))
    pfa.reset_launch_counts()
    got = attend(q, T.PagedKV(tk, tables), T.PagedKV(tv, tables), q_offset=pos, kv_length=pos + 1)
    np.testing.assert_array_equal(got.numpy(), T.paged_attend(q, tk, tv, tables, pos).numpy())
    qc = t(rng.standard_normal((1, 6, 4, 16)).astype(np.float32))
    got = attend(qc, T.PagedKV(tk, tables[1:]), T.PagedKV(tv, tables[1:]), q_offset=10, kv_length=14)
    np.testing.assert_array_equal(got.numpy(), T.paged_prefill_attend(qc, tk, tv, tables[1], 10, 4).numpy())
    counts = [pfa.paged_flash_attend.launches, pfa.paged_flash_prefill_attend.launches,
              pfa.paged_flash_attend.kv_quant_launches, pfa.paged_flash_prefill_attend.kv_quant_launches]
    assert counts == [0, 0, {"int8": 0, "nf4a": 0}, {"int8": 0, "nf4a": 0}]


# ------------------------------------------------------------------ backend

N_BLOCKS = 2
L, PS, MAX_PAGES = 3, 8, 6
MAXLEN = PS * MAX_PAGES
# step outputs: atol 2e-5 in f32, as tests/test_mixed_batching.py uses. Both
# sides attend over the same decoded pools; a new row whose value sat on a
# quantization midpoint could still round to the neighbouring code on one
# side (float32 rounding of the projections), so the pools are held within
# one code step and the share of differing codes is reported (observed on
# these seeds: outputs within 3e-8, no code differs)
STEP_TOL = 2e-5


@pytest.fixture(scope="module", params=KINDS)
def kv_backends(request, tmp_path_factory):
    kind = request.param
    path = make_tiny_mistral(str(tmp_path_factory.mktemp("models")), n_layers=N_BLOCKS, window=6)
    jfamily, jcfg = jax_block_config(path)
    per_block = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(N_BLOCKS)]
    jax_backend = JaxBackend(
        jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block),
        first_block=0, n_blocks=N_BLOCKS, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32,
        use_flash=False, kv_quant_type=kind,
    )
    family, cfg = get_block_config(path)
    backend = TransformerBackend(
        family, cfg,
        stacked_from_numpy([jax.tree_util.tree_map(np.asarray, p) for p in per_block], "cpu", torch.float32),
        first_block=0, n_blocks=N_BLOCKS, device="cpu", compute_dtype=torch.float32, kv_quant_type=kind,
    )
    return kind, jax_backend, backend, cfg


def test_backend_descriptors_and_bytes(kv_backends):
    kind, jax_backend, backend, _ = kv_backends
    jdescs = jax_backend.paged_cache_descriptors(6, 8, 0, 2)
    descs = backend.paged_cache_descriptors(6, 8, 0, 2)
    assert [d.shape for d in descs] == [tuple(d.shape) for d in jdescs]
    assert [str(d.dtype).split(".")[-1] for d in descs] == [jnp.dtype(d.dtype).name for d in jdescs]
    assert backend.kv_bytes_per_token() == jax_backend.kv_bytes_per_token()
    assert backend.cache_bytes_per_token() == jax_backend.cache_bytes_per_token()
    # the descriptors' bytes are the advertised stored bytes, zero-initialised
    assert sum(d.nbytes for d in descs) == backend.kv_bytes_per_token() * 6 * 8
    assert all(not d.make_zeros().any() for d in descs)


def _step_pools(rng, backend, kind, n_pages):
    """Seeded quantized span pools [n_blocks, n_pages, ...] as the JAX and
    the port backend take them (same bytes)."""
    shape = (N_BLOCKS, n_pages, PS, backend.num_kv_heads, backend.head_dim)
    jpools, tpools = [], []
    for _ in range(2):
        codes, scales = jax_quantize(jnp.asarray(rng.standard_normal(shape) * 0.5, jnp.float32), kind)
        jpools.append(J.PagedPool(codes, scales))
        tpools.append(T.PagedPool(t(np.asarray(codes)), t(np.asarray(scales))))
    return tuple(jpools), tuple(tpools)


def _compare_pools(kind, jpools, tpools):
    """Each decoded row within one quantization step of JAX's; returns the
    share of codes that differ."""
    differ, total = 0, 0
    for jp, tp in zip(jpools, tpools):
        want = np.asarray(J.dequantize_kv(jp.codes, jp.scales, kind, jnp.float32), np.float64)
        got = T.dequantize_kv(tp.codes, tp.scales, kind, torch.float32).double().numpy()
        absmax = np.abs(want).max(axis=-1, keepdims=True)
        # a flipped code moves its element by one inter-code gap: at most
        # twice the half-gap round-trip bound
        assert (np.abs(got - want) <= 2 * RT_BOUND[kind] * absmax + 1e-6).all()
        np.testing.assert_allclose(tp.scales.numpy(), np.asarray(jp.scales), rtol=1e-5, atol=1e-7)
        differ += int((tp.codes.numpy() != np.asarray(jp.codes)).sum())
        total += tp.codes.numel()
    return differ / total


def test_backend_steps_match_jax(kv_backends):
    """A decode step and a mixed step (a 20-token chunk over 13 + 7 rows) of
    a quantized span, port against JAX, from the same quantized pools, on
    permuted oversubscribed tables with an idle lane."""
    kind, jax_backend, backend, cfg = kv_backends
    rng = np.random.default_rng(12)
    n_pages = 20
    tables = np.full((L, MAX_PAGES), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane, need in enumerate((7, 20, 18)):
        for s in range(-(-need // PS)):
            tables[lane, s] = free.pop()
    jpools, tpools = _step_pools(rng, backend, kind, n_pages)
    hidden = (rng.standard_normal((L, 1, cfg.hidden_size)) * 0.1).astype(np.float32)

    positions = np.array([5, MAXLEN, 17], np.int32)  # lane 1 idles
    want, jpools = jax_backend.paged_decode_step(hidden, jpools, positions, tables)
    got, out_pools = backend.paged_decode_step(hidden, tpools, positions, tables)
    assert out_pools[0] is tpools[0]  # written in place
    for lane in (0, 2):
        np.testing.assert_allclose(got.numpy()[lane], np.asarray(want)[lane], atol=STEP_TOL, rtol=0)

    prompt = (rng.standard_normal((1, 20, cfg.hidden_size)) * 0.1).astype(np.float32)
    positions = np.array([6, MAXLEN, 18], np.int32)  # lane 1 prefills
    want, want_c, jpools = jax_backend.paged_mixed_step(hidden, jpools, positions, tables, prompt[:, :13], 1, 0)
    got, got_c, _ = backend.paged_mixed_step(hidden, tpools, positions, tables, prompt[:, :13], 1, 0)
    for lane in (0, 2):
        np.testing.assert_allclose(got.numpy()[lane], np.asarray(want)[lane], atol=STEP_TOL, rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=STEP_TOL, rtol=0)
    idle = np.zeros((L, 1, cfg.hidden_size), np.float32)
    sentinel = np.full((L,), MAXLEN, np.int32)
    _, want_c, jpools = jax_backend.paged_mixed_step(idle, jpools, sentinel, tables, prompt[:, 13:], 1, 13)
    _, got_c, _ = backend.paged_mixed_step(idle, tpools, sentinel, tables, prompt[:, 13:], 1, 13)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=STEP_TOL, rtol=0)
    share = _compare_pools(kind, jpools, tpools)
    print(f"{kind}: {share:.2e} of the pool's codes differ from JAX's")
    assert share < 1e-3


def test_batcher_serves_a_quantized_pool(kv_backends):
    """The batcher budgets the 4 buffers by their stored bytes, hands the
    steps a (PagedPool, PagedPool) pair, and a prefill fed in budget-sized
    mixed-step chunks leaves the same codes and replies as one whole chunk."""
    from petals_tpu_torch.server.batching import DecodeBatcher
    from petals_tpu_torch.server.memory_cache import MemoryCache
    from petals_tpu_torch.server.task_queue import PriorityTaskQueue

    kind, _, backend, cfg = kv_backends
    rng = np.random.default_rng(13)
    prompt = torch.from_numpy((rng.standard_normal((1, 21, cfg.hidden_size)) * 0.1).astype(np.float32))
    token = torch.from_numpy((rng.standard_normal((1, 1, cfg.hidden_size)) * 0.1).astype(np.float32))

    async def run(budget):
        queue = PriorityTaskQueue()
        queue.start()
        cache = MemoryCache(None)
        batcher = DecodeBatcher(backend, cache, queue, n_lanes=2, max_length=32, page_size=8,
                                prefill_token_budget=budget)
        try:
            lane = await batcher.acquire_lane(timeout=5)
            assert cache._current_size_bytes == backend.kv_bytes_per_token() * batcher.n_pages * 8
            outs = [await batcher.prefill_lane(lane, prompt, 0), await batcher.step(lane, token, 21)]
            k_pool, v_pool = batcher._buffers()
            assert isinstance(k_pool, T.PagedPool) and k_pool.kind == kind
            assert batcher.pool_info() == {"kv_quant": kind, "kv_bytes_per_token": backend.kv_bytes_per_token()}
            return outs, [t_.clone() for pool in (k_pool, v_pool) for t_ in pool], batcher.stats["mixed_steps"]
        finally:
            await batcher.close()
            queue.shutdown()

    chunked, chunked_pool, n_mixed = asyncio.run(asyncio.wait_for(run(8), 60))
    whole, whole_pool, _ = asyncio.run(asyncio.wait_for(run(64), 60))
    assert n_mixed == 3  # 8 + 8 + 5 tokens
    for got, want in zip(chunked, whole):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=STEP_TOL, rtol=0)
    for got, want in zip(chunked_pool, whole_pool):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kv_quant_checks_match_jax(tmp_path):
    """A bad kind, and nf4a at an odd head_dim, raise in both packages."""
    path = make_tiny_llama(str(tmp_path), n_layers=1)
    jfamily, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    with pytest.raises(ValueError):
        JaxBackend(jfamily, jcfg, {}, first_block=0, n_blocks=1, memory_cache=JaxMemoryCache(None),
                   use_flash=False, kv_quant_type="int4")
    with pytest.raises(ValueError):
        TransformerBackend(family, cfg, [{}], first_block=0, n_blocks=1, device="cpu", kv_quant_type="int4")
    odd = types.SimpleNamespace(**{**vars(cfg), "head_dim": 15})
    jodd = types.SimpleNamespace(**{**vars(jcfg), "head_dim": 15})
    with pytest.raises(ValueError, match="even head_dim"):
        JaxBackend(jfamily, jodd, {}, first_block=0, n_blocks=1, memory_cache=JaxMemoryCache(None),
                   use_flash=False, kv_quant_type="nf4a")
    with pytest.raises(ValueError, match="even head_dim"):
        TransformerBackend(family, odd, [{}], first_block=0, n_blocks=1, device="cpu", kv_quant_type="nf4a")
    with pytest.raises(ValueError, match="kv_quant_type"):
        Server(path, first_block=0, num_blocks=1, device="cpu", kv_quant_type="fp8")


# ------------------------------------------------------------------ server

N_LAYERS = 2


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def _head(model_path):
    weights = load_file(os.path.join(model_path, "model.safetensors"))
    _, cfg = jax_block_config(model_path)
    return (weights["model.embed_tokens.weight"], weights["model.norm.weight"], weights["lm_head.weight"],
            cfg.rms_norm_eps), cfg


PROMPT = [3, 17, 42, 5, 99]


async def _forced_logits(client, uids, head, tokens):
    """Feed PROMPT, then ``tokens`` one by one, over raw ptu.inference
    steps; returns the logits after each step (head applied here)."""
    from petals_tpu.rpc.serialization import deserialize_array, serialize_array
    from tests.test_torch_server import _rms

    embed, norm_w, lm_head, eps = head
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": 64, "batch_size": 1})
    await stream.recv(timeout=60)
    logits, hidden = [], embed[np.asarray(PROMPT)][None]
    for tok in tokens:
        await stream.send({"tensors": {"hidden": serialize_array(hidden.astype(np.float32))}})
        out = deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"])
        logits.append(_rms(out[0, -1].astype(np.float32), norm_w, eps) @ lm_head.T)
        hidden = embed[[tok]][None]
    await stream.end()
    return logits


def _serve_both(model_path, quant_type, kv_quant_type, drive, budget=None):
    """Run ``drive(client)`` against a port server, then a petals_tpu server,
    both configured alike; returns ((port info, port result), (JAX info,
    JAX result))."""
    from petals_tpu.rpc import RpcClient

    async def main():
        server = Server(
            model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
            attn_cache_bytes=budget, batch_max_length=128, page_size=16, prefill_token_budget=16,
            quant_type=quant_type, kv_quant_type=kv_quant_type, throughput=1.0,
        )
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            port = (await client.call("ptu.info", {}, timeout=10), await drive(client))
        finally:
            await client.close()
            await server.shutdown()
        jserver = JaxServer(
            model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0, attn_cache_bytes=budget,
            batching=True, batch_max_length=128, page_size=16,
            prefix_cache_bytes=0, prefix_device_bytes=0, server_side_generation=False,
            quant_type=quant_type, quant_weight_cache=False, kv_quant_type=kv_quant_type,
        )
        await jserver.start()
        jclient = await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)
        try:
            ref = (await jclient.call("ptu.info", {}, timeout=10), await drive(jclient))
        finally:
            await jclient.close()
            await jserver.shutdown()
        return port, ref

    return asyncio.run(main())


@pytest.mark.parametrize("kv_quant_type", KINDS)
def test_greedy_tokens_match_jax_server(model_path, kv_quant_type):
    """A port server with a quantized KV pool emits the same greedy tokens as
    a petals_tpu server with the same --kv_quant_type; for the same cache
    budget ptu.info reports the same cache tokens (cache_tokens_available:
    free bytes over a token's logical bytes; the announce's
    cache_tokens_left: over its stored bytes), state and lanes, and the
    pool's kind."""
    from tests.test_torch_server import _greedy, _uids

    head, cfg = _head(model_path)
    uids = _uids(model_path)
    # floating-point bytes of 3 lanes of 128 tokens, doubled (a pool takes
    # at most half the budget): 3 lanes unquantized, more when quantized
    budget = 2 * 3 * 128 * 2 * N_LAYERS * cfg.num_key_value_heads * cfg.head_dim * 4
    (info, port_tokens), (jinfo, jax_tokens) = _serve_both(
        model_path, "none", kv_quant_type, lambda c: _greedy(c, uids, head, PROMPT, 8), budget
    )
    assert info["kv_quant"] == info["continuous_batching"]["kv_quant"] == kv_quant_type
    assert info["continuous_batching"]["kv_bytes_per_token"] == jinfo["pool"]["kv_bytes_per_token"]
    assert info["cache_tokens_available"] == jinfo["cache_tokens_available"]
    assert info["cache_tokens_left"] == jinfo["cache_tokens_left"] > info["cache_tokens_available"]
    assert info["state"] == jinfo["state"]
    assert info["continuous_batching"]["lanes"] == jinfo["continuous_batching"]["lanes"] > 3
    assert len(port_tokens) == 8
    assert port_tokens == jax_tokens


# Quantized weights AND a quantized pool. The port's plain quantized matmul
# is within one bfloat16 ulp of JAX's, not bit-equal (tests/test_torch_quant.py),
# and such a difference in a K/V row flips an nf4a code whose value sits near
# a midpoint: a step's logits then differ by up to ~8e-3 (observed on this
# checkpoint; 1e-3 with a floating-point pool, 1e-7 with dense weights). The
# petals_tpu server's own top-two logits come within 5.3e-4 and 2.8e-3 of each
# other on this prompt, so a free-running greedy stream can take the other
# branch there. So both servers are fed petals_tpu's greedy stream, and the
# port must give logits within LOGIT_TOL of it at every step and pick the
# same token wherever petals_tpu's pick leads by more than twice that.
LOGIT_TOL = 2e-2


def test_quantized_weights_and_pool_follow_jax_server(model_path):
    from tests.test_torch_server import _greedy, _uids

    head, _ = _head(model_path)
    uids = _uids(model_path)
    (_, _), (_, jax_tokens) = _serve_both(model_path, "nf4a", "nf4a", lambda c: _greedy(c, uids, head, PROMPT, 8))
    (info, port_logits), (_, jax_logits) = _serve_both(
        model_path, "nf4a", "nf4a", lambda c: _forced_logits(c, uids, head, jax_tokens)
    )
    assert info["quant_type"] == info["kv_quant"] == "nf4a"
    decided = 0
    for step, (got, want, tok) in enumerate(zip(port_logits, jax_logits, jax_tokens)):
        assert int(want.argmax()) == tok
        assert np.abs(got - want).max() <= LOGIT_TOL, step
        top2 = np.sort(want)[-2:]
        if top2[1] - top2[0] > 2 * LOGIT_TOL:
            decided += 1
            assert int(got.argmax()) == tok, step
    assert decided >= 2


def _started(server):
    """``server`` after one start and shutdown: ``start()`` loads its span."""

    async def cycle():
        await server.start()
        await server.shutdown()

    asyncio.run(cycle())
    return server


def test_cli_passes_kv_quant_type_through(model_path, tmp_path, monkeypatch):
    from petals_tpu_torch.cli.run_server import attn_cache_bytes_for, build_parser, build_server

    base = [model_path, "--first_block", "0", "--num_blocks", "2", "--device", "cpu", "--dtype", "float32"]
    assert build_parser().parse_args(base).kv_quant_type == "none"
    args = build_parser().parse_args(base + ["--kv_quant_type", "nf4a", "--quant_type", "int8"])
    monkeypatch.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path))  # the measured throughput's cache
    server = _started(build_server(args))
    assert server.kv_quant_type == server.backend.kv_quant_type == "nf4a"
    assert server.quant_type == "int8"
    # the budget stays in floating-point bytes, whatever the pool's encoding
    assert attn_cache_bytes_for(args) == attn_cache_bytes_for(build_parser().parse_args(base))
    descs = server.backend.paged_cache_descriptors(4, 16, 0, 2)
    assert [d.dtype for d in descs] == [torch.uint8, torch.uint8, torch.float32, torch.float32]
    with pytest.raises(SystemExit):  # the JAX CLI's choices only
        build_parser().parse_args(base + ["--kv_quant_type", "int4"])
