"""Speculative decoding of the port (ops/paged_attention.py's per-lane
multi-row write, the decode wrapper's k+1-row arm, server/spec_decode.py,
the backend's ``paged_spec_verify_step``, the batcher's spec tick, the
handler, the server and the CLI) against petals_tpu's, on the CPU in
float32 at the reference's fixture: tiny llama, 4 blocks, 3 lanes, page 8,
k 3, window 48 (tests/test_spec_decode.py).

Tolerances: pools written by ``scatter_lane_chunk_rows`` and the
multi-row ``paged_update_kv`` are byte-equal to JAX's (bf16, int8, nf4a);
the per-row causal ``paged_attend`` within 1e-5 of JAX's
``attend_reference`` at float32; the verify step's ``g_hat`` and
``n_emit`` equal, its pools within 2e-5 (every other step of the port is
held to JAX's there); the draft's proposals equal; token streams equal.
On the CPU every kernel wrapper takes its plain version; the card's k+1-row
arm is in tests/test_torch_kernels_cuda.py."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.from_pretrained import load_client_params as jax_load_client
from petals_tpu.ops import paged_attention as J
from petals_tpu.ops.attention import attend_reference as jax_attend_reference
from petals_tpu.ops.sampling import sampling_vectors
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.server.spec_decode import DraftModel as JaxDraftModel
from petals_tpu_torch.client.from_pretrained import load_client_params
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.spec_decode import DraftModel
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.test_torch_dense_programs import OnceCapture
from tests.test_torch_prefix_cache import _Loop
from tests.test_torch_step_programs import _clone_pools, _tensors
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)

TOL = 2e-5
ATTEND_TOL = 1e-5
SPEC_K = 3
S = SPEC_K + 1
N_LAYERS = 4
PS = 8
LANES = 3
WINDOW = 48


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def _bits(x):
    """The stored bytes of a JAX array or a torch tensor, as numpy."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    a = np.asarray(x)
    return a.view(np.uint8)


def _pools(kind, rng, n_pages, hkv, d):
    """A random pool of ``kind`` as (JAX, port) twins: "none" is bfloat16,
    the quantized kinds are encoded by the JAX package's jitted encoder."""
    rows = (rng.standard_normal((n_pages, PS, hkv, d)) * 0.5).astype(np.float32)
    if kind == "none":
        return jnp.asarray(rows, jnp.bfloat16), torch.from_numpy(rows).to(torch.bfloat16)
    codes, scales = jax.jit(J.quantize_kv_rows, static_argnums=1)(jnp.asarray(rows), kind)
    return (J.PagedPool(codes, scales),
            T.PagedPool(torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scales))))


def _same_pool(got, want):
    for g, w in zip(_tensors((got,)), (want.codes, want.scales) if isinstance(want, J.PagedPool) else (want,)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _lane_scene(rng, n_pages=14, max_pages=4):
    """3 lanes on permuted pages: lane 0 writes across a page boundary, lane
    1 into an unallocated slot past its last page (those rows drop), lane 2
    idles at the sentinel over pages of its own."""
    tables = np.full((LANES, max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane, n in ((0, 2), (1, 2), (2, 3)):
        for s in range(n):
            tables[lane, s] = free.pop()
    positions = np.array([6, 14, PS * max_pages], np.int32)
    return tables, positions


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_scatter_lane_chunk_rows_is_byte_equal_to_petals_tpu(kind):
    rng = np.random.default_rng(0)
    hkv, d, n_pages = 2, 16, 14
    tables, positions = _lane_scene(rng, n_pages)
    jpool, tpool = _pools(kind, rng, n_pages, hkv, d)
    rows = rng.standard_normal((LANES, S, hkv, d)).astype(np.float32)
    if kind == "none":
        jrows, trows = jnp.asarray(rows, jnp.bfloat16), torch.from_numpy(rows).to(torch.bfloat16)
    else:
        jrows, trows = jnp.asarray(rows), torch.from_numpy(rows)
    want = jax.jit(J.scatter_lane_chunk_rows)(jpool, jrows, jnp.asarray(tables), jnp.asarray(positions))
    before = [t.clone() for t in _tensors((tpool,))]
    T.scatter_lane_chunk_rows(tpool, trows, torch.from_numpy(tables), torch.from_numpy(positions))
    _same_pool(tpool, want)
    changed = sum(int((a != b).reshape(n_pages, PS, -1).any(-1).sum()) for a, b in
                  zip(before[:1], list(_tensors((tpool,)))[:1]))
    # lane 0 writes 4 rows, lane 1 the 2 rows left in its second page
    assert changed == 6


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_multi_row_paged_update_kv_is_byte_equal_to_petals_tpu(kind):
    rng = np.random.default_rng(1)
    hkv, d, n_pages = 2, 16, 14
    tables, positions = _lane_scene(rng, n_pages)
    (jk, tk), (jv, tv) = _pools(kind, rng, n_pages, hkv, d), _pools(kind, rng, n_pages, hkv, d)
    dt = (jnp.bfloat16, torch.bfloat16) if kind == "none" else (jnp.float32, torch.float32)
    k_new, v_new = (rng.standard_normal((LANES, S, hkv, d)).astype(np.float32) for _ in range(2))

    @jax.jit
    def jax_update(jk, jv, k_new, v_new, tables, positions):
        k_kv, v_kv, kv_len = J.paged_update_kv(J.PagedKV(jk, tables), J.PagedKV(jv, tables), k_new, v_new,
                                               positions)
        return k_kv.pool, v_kv.pool, kv_len

    wk, wv, wlen = jax_update(jk, jv, jnp.asarray(k_new, dt[0]), jnp.asarray(v_new, dt[0]), jnp.asarray(tables),
                              jnp.asarray(positions))
    t_tables = torch.from_numpy(tables)
    _, _, got_len = T.paged_update_kv(
        T.PagedKV(tk, t_tables), T.PagedKV(tv, t_tables), torch.from_numpy(k_new).to(dt[1]),
        torch.from_numpy(v_new).to(dt[1]), torch.from_numpy(positions))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(wlen))
    np.testing.assert_array_equal(got_len.numpy(), positions + S)
    _same_pool(tk, wk)
    _same_pool(tv, wv)


@pytest.mark.parametrize("window", [None, 5])
def test_multi_row_paged_attend_holds_to_jax_attend_reference(window):
    """Each of a lane's S query rows sees the slots up to its own position
    (within 1e-5 at float32); holes lie past every active lane's rows."""
    rng = np.random.default_rng(2)
    hq, hkv, d, n_pages, max_pages = 4, 2, 16, 14, 4
    tables, positions = _lane_scene(rng, n_pages, max_pages)
    # lane 1's rows reach its third slot: give it a page there
    tables[1, 2] = sorted(set(range(n_pages)) - set(tables.ravel().tolist()))[0]
    kp = rng.standard_normal((n_pages, PS, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, PS, hkv, d)).astype(np.float32)
    q = rng.standard_normal((LANES, S, hq, d)).astype(np.float32)
    k = J.gather_pages(jnp.asarray(kp), jnp.asarray(tables))
    v = J.gather_pages(jnp.asarray(vp), jnp.asarray(tables))
    pos = jnp.asarray(positions)
    want = np.asarray(jax_attend_reference(jnp.asarray(q), k, v, q_offset=pos, kv_length=pos + S,
                                           sliding_window=window))
    got = T.paged_attend(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(tables),
                         torch.from_numpy(positions), sliding_window=window).numpy()
    np.testing.assert_allclose(got[:2], want[:2], atol=ATTEND_TOL, rtol=0)
    # the wrapper the blocks call takes the plain version on CPU tensors
    from petals_tpu_torch.ops.paged_flash_attention import paged_flash_attend

    wrapped = paged_flash_attend(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                                 torch.from_numpy(tables), torch.from_numpy(positions), sliding_window=window)
    assert torch.equal(wrapped, torch.from_numpy(got))
    # row j equals a one-row decode at position p + j (the card's expansion)
    for j in range(S):
        one = T.paged_attend(torch.from_numpy(q[:, j : j + 1]), torch.from_numpy(kp), torch.from_numpy(vp),
                             torch.from_numpy(tables), torch.from_numpy(positions + j), sliding_window=window)
        np.testing.assert_allclose(one.numpy()[:2, 0], got[:2, j], atol=ATTEND_TOL, rtol=0)


# ------------------------------------------------------------- backends


_BACKENDS = {}


def _backends(path, kv="none", n_blocks=2):
    """(JAX backend, port backend, JAX client leaves, port client leaves)
    over the same float32 blocks [0, n_blocks) of ``path`` (a 2-block
    "whole model" for the client leaves, as the reference's parity tests
    build it)."""
    key = (path, kv, n_blocks)
    if key not in _BACKENDS:
        jfamily, jcfg = jax_block_config(path)
        blocks = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(n_blocks)]
        jax_backend = JaxBackend(
            jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks), first_block=0,
            n_blocks=n_blocks, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
            kv_quant_type=kv,
        )
        family, cfg = get_block_config(path)
        backend = TransformerBackend(
            family, cfg, stacked_from_numpy([{k: np.asarray(v) for k, v in b.items()} for b in blocks], "cpu",
                                            torch.float32),
            first_block=0, n_blocks=n_blocks, device="cpu", compute_dtype=torch.float32, kv_quant_type=kv,
        )
        jparams = jax_load_client(path, dtype=jnp.float32, family=jfamily, cfg=jcfg)
        _BACKENDS[key] = (jax_backend, backend, jparams, load_client_params(path, device="cpu"))
    return _BACKENDS[key]


def _vecs(n, vocab, sampled, draw_idx):
    v = sampling_vectors(n, vocab)
    if sampled:
        v["do_sample"][:] = True
        v["temperature"][:] = 0.8
        v["top_k"][:] = 10
        v["seeds"][:] = 42 + np.arange(n)
        v["draw_idx"][:] = draw_idx
    return v


def _prefilled_pools(jb, cfg, positions, max_pages, n_pages, rows, rng, kv="none"):
    """Per-lane prompt caches (random hidden prompts through the JAX
    backend) scattered into permuted pages, each lane with slots for
    ``rows`` writes past its position; the pools as (JAX, port) twins."""
    maxlen = PS * max_pages
    kd, vd = jb.cache_descriptors(1, maxlen, 0, jb.n_blocks)
    dense = []
    for p in positions:
        kv_ = (kd.make_zeros(), vd.make_zeros())
        if 0 < p < maxlen:
            _, kv_ = jb.inference_step((rng.standard_normal((1, int(p), cfg.hidden_size)) * 0.1).astype(np.float32),
                                       kv_, 0)
        dense.append((np.asarray(kv_[0])[:, 0], np.asarray(kv_[1])[:, 0]))
    tables = np.full((len(positions), max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    shape = (jb.n_blocks, n_pages, PS, cfg.num_key_value_heads, cfg.head_dim)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    for lane, p in enumerate(positions):
        if p >= maxlen:
            continue
        for s in range(-(-int(p + rows) // PS)):
            page = free.pop()
            tables[lane, s] = page
            kp[:, page] = dense[lane][0][:, s * PS : (s + 1) * PS]
            vp[:, page] = dense[lane][1][:, s * PS : (s + 1) * PS]
    if kv == "none":
        return tables, (jnp.asarray(kp), jnp.asarray(vp)), (torch.from_numpy(kp), torch.from_numpy(vp))
    enc = jax.jit(J.quantize_kv_rows, static_argnums=1)
    jpools, tpools = [], []
    for rows_ in (kp, vp):
        codes, scales = enc(jnp.asarray(rows_), kv)
        jpools.append(J.PagedPool(codes, scales))
        tpools.append(T.PagedPool(torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scales))))
    return tables, tuple(jpools), tuple(tpools)


def _jax_copy(pools):
    return tuple(J.PagedPool(jnp.array(p.codes), jnp.array(p.scales)) if isinstance(p, J.PagedPool)
                 else jnp.array(p) for p in pools)


def _port_plain(pb, params, pools, tables, positions, use_token, t0, n_steps, sampled, draw0=1):
    """Ground truth on the port: ``n_steps`` of its plain generation step,
    one token a tick (draw_idx advancing one per emitted token)."""
    L = len(positions)
    toks, pos = np.asarray(t0, np.int64).copy(), np.asarray(positions, np.int32).copy()
    hidden = np.zeros((L, 1, pb.hidden_size), np.float32)
    stream = []
    for i in range(n_steps):
        _, nxt, _ = pb.paged_gen_decode_step(params, hidden, toks, use_token, pools, pos, tables,
                                             sampling_vecs=_vecs(L, pb.cfg.vocab_size, sampled, draw0 + i))
        toks = np.where(use_token, nxt.numpy(), toks)
        stream.append(toks.copy())
        pos = pos + use_token.astype(np.int32)
    return np.stack(stream, axis=1)


@pytest.mark.parametrize("kv", ["none", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_verify_step_equals_petals_tpu(model_path, kv, sampled):
    """Direct parity on permuted tables with an idle lane at the sentinel:
    cooperative drafts (the plain stream) accept the whole window, hostile
    ones roll back to one token, a partial match stops at the first miss;
    g_hat and n_emit equal the JAX step's, pools within 2e-5 (an int8 code
    at most one step apart where a value rounds on a midpoint), and no page
    outside the tables is written."""
    jb, pb, jparams, params = _backends(model_path, kv)
    rng = np.random.default_rng(3)
    max_pages, n_pages = 4, 17
    positions = np.array([4, 9, PS * max_pages], np.int32)
    use_token = np.array([True, True, False])
    t0 = np.array([7, 11, 0], np.int32)
    tables, jpools, tpools = _prefilled_pools(jb, pb.cfg, positions, max_pages, n_pages, S, rng, kv)
    plain = _port_plain(pb, params, _clone_pools(tpools), tables, positions, use_token, t0, S, sampled)
    bad = (plain[:, :SPEC_K] + 1) % pb.cfg.vocab_size
    part = bad.copy()
    part[:, 0] = plain[:, 0]
    for drafts, want_emit in ((plain[:, :SPEC_K], S), (bad, 1), (part, 2)):
        tokens = np.concatenate([t0[:, None], drafts], axis=1).astype(np.int32)
        vec = _vecs(LANES, pb.cfg.vocab_size, sampled, 1)
        wg, wm, (wk, wv) = jb.paged_spec_verify_step(jparams, tokens, _jax_copy(jpools), positions, tables,
                                                     sampling_vecs=vec)
        got_pools = _clone_pools(tpools)
        g, m, _ = pb.paged_spec_verify_step(params, tokens, got_pools, positions, tables, sampling_vecs=vec)
        assert g.dtype == torch.int32 and m.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[:2], np.asarray(wg)[:2])
        np.testing.assert_array_equal(m.numpy()[:2], np.asarray(wm)[:2])
        assert (m.numpy()[:2] == want_emit).all(), (sampled, want_emit, m)
        np.testing.assert_array_equal(g.numpy()[:2, :want_emit], plain[:2, :want_emit])
        for got, want in zip(got_pools, (wk, wv)):
            if kv == "none":
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
            else:
                assert np.abs(got.codes.numpy().astype(int) - np.asarray(want.codes).astype(int)).max() <= 1
        untouched = sorted(set(range(n_pages)) - set(tables[tables >= 0].ravel().tolist()))
        for got, orig in zip(got_pools, tpools):
            for a, b in zip(_tensors((got,)), _tensors((orig,))):
                assert torch.equal(a[:, untouched], b[:, untouched]), "a write leaked outside the tables"


def test_spec_verify_k1_degenerates_bit_exact(model_path):
    """k = 1: a right draft emits plain decode's two tokens, a wrong one its
    first, greedy and sampled, equal to the JAX step's."""
    jb, pb, jparams, params = _backends(model_path)
    rng = np.random.default_rng(9)
    positions, use_token, t0 = np.array([6, 3], np.int32), np.array([True, True]), np.array([2, 9], np.int32)
    tables, jpools, tpools = _prefilled_pools(jb, pb.cfg, positions, 3, 9, 2, rng)
    for sampled in (False, True):
        plain = _port_plain(pb, params, _clone_pools(tpools), tables, positions, use_token, t0, 2, sampled)
        for drafts, n in ((plain[:, :1], 2), ((plain[:, :1] + 1) % pb.cfg.vocab_size, 1)):
            tokens = np.concatenate([t0[:, None], drafts], axis=1).astype(np.int32)
            vec = _vecs(2, pb.cfg.vocab_size, sampled, 1)
            wg, wm, _ = jb.paged_spec_verify_step(jparams, tokens, _jax_copy(jpools), positions, tables,
                                                  sampling_vecs=vec)
            g, m, _ = pb.paged_spec_verify_step(params, tokens, _clone_pools(tpools), positions, tables,
                                                sampling_vecs=vec)
            assert (m.numpy() == n).all()
            np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
            np.testing.assert_array_equal(g.numpy(), np.asarray(wg))
            np.testing.assert_array_equal(g.numpy()[:, :n], plain[:, :n])


def test_spec_rollback_then_plain_decode_consistent(model_path):
    """Rollback is position truncation only: after a hostile verify (1 of
    S rows committed, the other k rows stale in the lane's pages), plain
    decode from the truncated position reproduces the from-scratch plain
    stream, on the same tables, as the JAX package's does."""
    jb, pb, jparams, params = _backends(model_path)
    rng = np.random.default_rng(11)
    positions, use_token, t0 = np.array([5, 12], np.int32), np.array([True, True]), np.array([4, 13], np.int32)
    n_cont = 3
    tables, jpools, tpools = _prefilled_pools(jb, pb.cfg, positions, 4, 14, S + n_cont, rng)
    for sampled in (False, True):
        ref = _port_plain(pb, params, _clone_pools(tpools), tables, positions, use_token, t0, 1 + n_cont, sampled)
        tokens = np.concatenate([t0[:, None], (ref[:, :SPEC_K] + 1) % pb.cfg.vocab_size], axis=1).astype(np.int32)
        tables_before = tables.copy()
        pools = _clone_pools(tpools)
        g, m, _ = pb.paged_spec_verify_step(params, tokens, pools, positions, tables,
                                            sampling_vecs=_vecs(2, pb.cfg.vocab_size, sampled, 1))
        assert (m.numpy() == 1).all()
        np.testing.assert_array_equal(tables, tables_before)
        cont = _port_plain(pb, params, pools, tables, positions + 1, use_token, g.numpy()[:, 0], n_cont, sampled,
                           draw0=2)
        np.testing.assert_array_equal(cont, ref[:, 1:])


def test_spec_verify_program_equals_eager_step(model_path):
    """The card's path (one step program a key) through a stand-in capture:
    bit-equal to the eager step on cloned int8 pools, one capture for every
    call on one pool, and the pool's warm-up with a draft captures it and
    writes nothing."""
    from petals_tpu_torch.telemetry.observatory import Observatory, TrackedGraph

    jb, pb, _, params = _backends(model_path, "int8")
    obs = Observatory()
    stub = TransformerBackend.__new__(TransformerBackend)
    stub.__dict__.update(pb.__dict__)
    capture = OnceCapture()
    for name in ("_decode_program", "_mixed_program", "_gen_program", "_spec_program"):
        setattr(stub, name, TrackedGraph(name, capture, observatory=obs))
    rng = np.random.default_rng(13)
    positions = np.array([4, 9, PS * 4], np.int32)
    tables, _, pools = _prefilled_pools(jb, pb.cfg, positions, 4, 17, 3 * S, rng, "int8")
    eager_pools = _clone_pools(pools)
    tokens = np.array([[7, 1, 2, 3], [11, 4, 5, 6], [0, 0, 0, 0]], np.int32)
    for step in range(3):
        vec = _vecs(LANES, pb.cfg.vocab_size, step % 2 == 1, 1 + step)
        got = stub.paged_spec_verify_step(params, tokens, pools, positions, tables, sampling_vecs=vec)
        want = pb.paged_spec_verify_step(params, tokens, eager_pools, positions, tables, sampling_vecs=vec)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(_tensors(pools), _tensors(eager_pools)))
        tokens = np.concatenate([got[0].numpy()[:, -1:], got[0].numpy()[:, :SPEC_K]], axis=1)
    assert stub._spec_program.counts.captures == 1 and stub._spec_program.counts.replays == 3
    fresh = _clone_pools(pools)
    before = [t.clone() for t in _tensors(fresh)]
    stub.warm_step_programs(fresh, LANES, tables.shape[1], 16, params, spec_k=SPEC_K)
    assert stub._spec_program.counts.captures == 2  # a fresh pool: its own graph
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(fresh)))


# ------------------------------------------------------------ the draft


def _drafts(path, quant_type="none"):
    jfamily, jcfg = jax_block_config(path)
    jdraft = JaxDraftModel.from_pretrained(path, spec_k=SPEC_K, window=WINDOW, quant_type=quant_type)
    draft = DraftModel.from_pretrained(path, spec_k=SPEC_K, window=WINDOW, quant_type=quant_type, device="cpu")
    return jdraft, draft


@pytest.mark.parametrize("quant_type", ["none", "nf4a"])
def test_draft_propose_equals_petals_tpu(model_path, quant_type):
    """Mixed lane counts (1 of 3, 2 of 3, 3 of 3, and a context past the
    window): the port's proposals equal the JAX draft's."""
    jdraft, draft = _drafts(model_path, quant_type)
    rng = np.random.default_rng(17)
    cases = [
        [list(rng.integers(0, 128, 7)), None, None],
        [None, list(rng.integers(0, 128, 1)), list(rng.integers(0, 128, 30))],
        [list(rng.integers(0, 128, n)) for n in (5, 12, WINDOW + 9)],
    ]
    for contexts in cases:
        want = jdraft.propose(contexts)
        got = draft.propose(contexts)
        assert got.shape == (LANES, SPEC_K) and got.dtype == np.int32
        active = [i for i, c in enumerate(contexts) if c]
        np.testing.assert_array_equal(got[active], want[active])
    assert DraftModel._buckets(3) == JaxDraftModel._buckets(3) == [1, 2, 3]
    assert DraftModel._buckets(8) == [1, 2, 4, 8]


def test_draft_programs_equal_the_eager_propose(model_path):
    """Each bucket's program (a stand-in capture) bit-equal to the eager
    body; ``warmup`` captures every bucket, and later proposals capture
    nothing."""
    from petals_tpu_torch.telemetry.observatory import Observatory, TrackedGraph

    _, draft = _drafts(model_path)
    stub = DraftModel.__new__(DraftModel)
    stub.__dict__.update(draft.__dict__)
    stub._program = TrackedGraph("draft_propose", OnceCapture(), observatory=Observatory())
    stub.warmup(LANES)
    assert stub._program.counts.captures == 3
    rng = np.random.default_rng(19)
    for contexts in ([list(rng.integers(0, 128, 9)), None, [5]], [list(rng.integers(0, 128, n)) for n in (3, 60, 20)]):
        np.testing.assert_array_equal(stub.propose(contexts), draft.propose(contexts))
    assert stub._program.counts.captures == 3 and stub._program.counts.replays >= 2


# ------------------------------------------------------------ pooled servers


SPEC_SERVER = dict(first_block=0, num_blocks=N_LAYERS, batch_lanes=LANES, batch_max_length=64, page_size=PS,
                   draft_model=None, spec_k=SPEC_K, draft_quant_type="none", draft_window=WINDOW, throughput=1.0,
                   prefix_cache_bytes=0, prefix_device_bytes=0)


@pytest.fixture(scope="module")
def spec_servers(model_path):
    """{"port", "jax"}: a whole-model port server and a petals_tpu server,
    each with the tiny model drafting for itself (unquantized, the
    reference's ``spec_swarm``), on one loop thread."""
    from petals_tpu.server.server import Server as JaxServer
    from petals_tpu_torch.server.server import Server

    loop = _Loop()
    spec = dict(SPEC_SERVER, draft_model=model_path)

    async def start():
        port = Server(model_path, device="cpu", compute_dtype=torch.float32, **spec)
        await port.start()
        jax_server = JaxServer(model_path, compute_dtype=jnp.float32, use_flash=False, **spec)
        await jax_server.start()
        return {"port": port, "jax": jax_server}

    servers = loop.run(start())
    servers["loop"] = loop
    yield servers

    async def stop():
        for name in ("port", "jax"):
            await servers[name].shutdown()

    loop.run(stop())
    loop.close()


def _embed(batcher, ctx, port):
    if port:
        return batcher.backend.family.client_embed(batcher.gen_params, torch.as_tensor([ctx]), batcher.backend.cfg)
    emb = batcher.backend.family.client_embed(batcher.gen_params, np.asarray([ctx], np.int32), batcher.backend.cfg)
    return np.asarray(emb, np.float32)


async def _pooled_generate(batcher, prompt_hidden, n_tokens, sampling=None, peer_id=None):
    """One session as the handler drives it: a lane, the prompt's prefill,
    then server-side generation. Returns (tokens [1, n], the usage delta)."""
    lane = await batcher.acquire_lane(timeout=60, peer_id=peer_id)
    try:
        out = await batcher.prefill_lane(lane, prompt_hidden, 0)
        toks = await batcher.generate_lane(lane, out[:, -1:], int(prompt_hidden.shape[1]), n_tokens, sampling)
        usage = batcher.pop_usage_delta(lane)
    finally:
        batcher.release_lane(lane)
    return np.asarray(toks), usage


def _plain(batcher):
    """A context in which ``batcher`` decodes plain (its draft detached, as
    the reference's tests do)."""
    import contextlib

    @contextlib.contextmanager
    def scope():
        draft, batcher.draft = batcher.draft, None
        try:
            yield
        finally:
            batcher.draft = draft

    return scope()


def test_pooled_spec_stream_equals_plain_and_petals_tpu(spec_servers):
    """The whole spec tick on the live lane pool (propose, one verify step,
    commit and rollback) emits plain decode's stream and a petals_tpu
    server's, greedy and seeded sampling alike. Acceptance is held on the
    greedy stream alone: its cooperative draft matches (> 0.9), where
    greedy drafts rarely equal a sampled token. Each verify row's uniform
    is the stream's draw ``len(collected) - 1 + j``, inside the stream's
    draws."""
    from petals_tpu_torch.ops.threefry import uniform_for_draw

    loop = spec_servers["loop"]
    port, jax_batcher = spec_servers["port"].batcher, spec_servers["jax"].handler.batcher
    rng = np.random.default_rng(21)
    ctx = [int(t) for t in rng.integers(0, 100, 7)]
    sampled = dict(do_sample=True, temperature=0.8, top_k=10, seed=1234, offset=0, context=ctx)
    n_new = 14
    verify, us = port.backend.paged_spec_verify_step, []

    def recording(*args, sampling_vecs, **kw):
        us.append(np.array(sampling_vecs["u"]))
        return verify(*args, sampling_vecs=sampling_vecs, **kw)

    async def streams(batcher, is_port):
        hidden = _embed(batcher, ctx, is_port)
        s0 = dict(batcher.stats)
        greedy, _ = await _pooled_generate(batcher, hidden, n_new, {"context": ctx})
        s1 = dict(batcher.stats)
        samp, _ = await _pooled_generate(batcher, hidden, n_new, dict(sampled))
        s2 = dict(batcher.stats)
        with _plain(batcher):
            plain_g, _ = await _pooled_generate(batcher, hidden, n_new, {"context": ctx})
            plain_s, _ = await _pooled_generate(batcher, hidden, n_new, dict(sampled))
        return greedy, samp, plain_g, plain_s, s0, s1, s2

    port.backend.paged_spec_verify_step = recording
    try:
        got = loop.run(streams(port, True))
    finally:
        del port.backend.paged_spec_verify_step
    want = loop.run(streams(jax_batcher, False))
    greedy, samp, plain_g, plain_s, s0, s1, s2 = got
    np.testing.assert_array_equal(greedy, plain_g)
    np.testing.assert_array_equal(samp, plain_s)
    np.testing.assert_array_equal(greedy, want[0])
    np.testing.assert_array_equal(samp, want[1])
    assert greedy.shape == (1, n_new)
    assert s2["spec_steps"] > s1["spec_steps"] > s0["spec_steps"] and s2["max_spec_lanes"] >= 1
    proposed, accepted = s1["spec_proposed"] - s0["spec_proposed"], s1["spec_accepted"] - s0["spec_accepted"]
    assert proposed > 0 and accepted / proposed > 0.9, (accepted, proposed)
    # the sampled stream's verify rows drew consecutive draws of its seed
    sampled_us = [u for u in us if u.any()]
    assert sampled_us
    draws = uniform_for_draw(1234, np.arange(1, n_new))
    at = 0
    for u in sampled_us:
        row = u[u.any(axis=1)][0]
        at = int(np.flatnonzero(draws == row[0])[0])
        np.testing.assert_array_equal(row, draws[at : at + S])
    assert at + S <= n_new - 1


def test_mixed_tick_spec_plain_prefill(spec_servers):
    """A speculating session, a 2-token session (remaining < k + 1: it never
    speculates) and a concurrent prefill share ticks: a spec step rode
    beside a generation step, a prefill chunk beside a spec step, and every
    stream equals its plain one."""
    loop = spec_servers["loop"]
    batcher = spec_servers["port"].batcher
    ticks = []
    run_spec, run_gen, run_mixed = batcher._run_batch_spec, batcher._run_batch_gen, batcher._run_batch_mixed

    def spec_tick(states):
        ticks.append(("spec", len(states)))
        return run_spec(states)

    def gen_tick(batch, states):
        ticks.append(("gen", len(states)))
        return run_gen(batch, states)

    def mixed_tick(batch, pf):
        ticks.append(("mixed", pf[1]))
        return run_mixed(batch, pf)

    async def main():
        rng = np.random.default_rng(23)
        ctx_a, ctx_b = ([int(t) for t in rng.integers(0, 100, n)] for n in (6, 5))
        hid_a, hid_b = _embed(batcher, ctx_a, True), _embed(batcher, ctx_b, True)
        pre = torch.from_numpy((rng.standard_normal((1, 20, batcher.backend.hidden_size)) * 0.1).astype(np.float32))

        async def prefill_only():
            while not any(t[0] == "spec" for t in ticks):
                await asyncio.sleep(0.001)
            lane = await batcher.acquire_lane(timeout=60)
            try:
                return await batcher.prefill_lane(lane, pre, 0)
            finally:
                batcher.release_lane(lane)

        (toks_a, _), (toks_b, _), pre_out = await asyncio.gather(
            _pooled_generate(batcher, hid_a, 16, {"context": ctx_a}),
            _pooled_generate(batcher, hid_b, 2, {"context": ctx_b}),
            prefill_only(),
        )
        with _plain(batcher):
            ref_a, _ = await _pooled_generate(batcher, hid_a, 16, {"context": ctx_a})
            ref_b, _ = await _pooled_generate(batcher, hid_b, 2, {"context": ctx_b})
        return toks_a, toks_b, pre_out, ref_a, ref_b

    batcher._run_batch_spec, batcher._run_batch_gen, batcher._run_batch_mixed = spec_tick, gen_tick, mixed_tick
    try:
        toks_a, toks_b, pre_out, ref_a, ref_b = loop.run(main())
    finally:
        del batcher._run_batch_spec, batcher._run_batch_gen, batcher._run_batch_mixed
    np.testing.assert_array_equal(toks_a, ref_a)
    np.testing.assert_array_equal(toks_b, ref_b)
    assert pre_out.shape == (1, 20, batcher.backend.hidden_size)
    kinds = [t[0] for t in ticks]
    assert "spec" in kinds and "gen" in kinds
    # each flush tick submits its spec step first, then the others of the tick
    assert any(a[0] == "spec" and b[0] in ("gen", "mixed") for a, b in zip(ticks, ticks[1:]))
    assert any(t[0] == "mixed" for t in ticks[kinds.index("spec"):])


def test_spec_ema_autodisable_keeps_the_stream(spec_servers):
    """A draft whose proposals keep missing drives the lane's acceptance EMA
    under the floor: speculation stops for a cooldown (``spec_disabled``
    counts it), and the stream is still plain decode's."""
    loop = spec_servers["loop"]
    batcher = spec_servers["port"].batcher

    async def main():
        rng = np.random.default_rng(29)
        ctx = [int(t) for t in rng.integers(0, 100, 6)]
        hidden = _embed(batcher, ctx, True)
        old_floor, batcher._spec_min_accept = batcher._spec_min_accept, 0.95
        batcher.draft.propose = lambda contexts: np.full((len(contexts), SPEC_K), 3, np.int32)
        disabled0, steps0 = batcher.stats["spec_disabled"], batcher.stats["spec_steps"]
        try:
            toks, _ = await _pooled_generate(batcher, hidden, 12, {"context": ctx})
        finally:
            batcher._spec_min_accept = old_floor
            del batcher.draft.propose
        spec_ticks = batcher.stats["spec_steps"] - steps0
        with _plain(batcher):
            ref, _ = await _pooled_generate(batcher, hidden, 12, {"context": ctx})
        return toks, ref, batcher.stats["spec_disabled"] - disabled0, spec_ticks

    toks, ref, disabled, spec_ticks = loop.run(main())
    assert disabled >= 1
    # the first miss trips the 0.95 floor; the cooldown outlasts the stream
    assert spec_ticks == 1
    np.testing.assert_array_equal(toks, ref)


def test_spec_ledger_bills_draft_and_verify(spec_servers):
    """The spec tick's whole wall is billed through ``note_compute``, the
    draft's share rides as ``draft_seconds``, every emitted token is billed
    once, ``acceptance_rate`` is derived per delta, and the allocator comes
    back whole: rollback freed and pinned nothing."""
    from petals_tpu_torch.telemetry.ledger import ResourceLedger

    loop = spec_servers["loop"]
    batcher = spec_servers["port"].batcher

    async def main():
        rng = np.random.default_rng(31)
        ctx = [int(t) for t in rng.integers(0, 100, 6)]
        old, batcher._ledger = batcher._ledger, ResourceLedger()
        try:
            _, usage = await _pooled_generate(batcher, _embed(batcher, ctx, True), 16, {"context": ctx},
                                              peer_id="tenant-spec")
        finally:
            batcher._ledger = old
        return usage

    usage = loop.run(main())
    assert usage["decode_tokens"] == 15, usage  # n_tokens - 1, spec and plain ticks
    assert usage["prefill_tokens"] == 6
    assert usage["spec_proposed"] > 0 and usage["spec_accepted"] >= 0
    assert 0.0 < usage["draft_seconds"] < usage["compute_seconds"]
    assert 0.0 <= usage["acceptance_rate"] <= 1.0
    assert usage["tokens_per_compute_second"] > 0
    assert batcher._pages.n_free == batcher.n_pages
    assert (batcher._pages.refs == 0).all()


async def _gen_reply(client, uids, embed, prompt, n, sampling=None):
    from petals_tpu_torch.rpc.serialization import serialize_array

    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": 64, "batch_size": 1})
    await stream.recv(timeout=60)
    step = {"tensors": {"hidden": serialize_array(embed[np.asarray(prompt)][None].astype(np.float32))},
            "gen_tokens": n, "gen_sampling": {**(sampling or {}), "offset": 0, "context": list(prompt)}}
    await stream.send(step)
    reply = await stream.recv(timeout=120)
    await stream.end()
    return reply


def test_server_replies_carry_acceptance_and_equal_petals_tpu(spec_servers, model_path):
    """Over the wire: a ``gen_tokens`` step on each server gives the same
    tokens (greedy and seeded), and the port's step_meta carries the
    stream's ``spec_proposed`` / ``spec_accepted`` / ``acceptance_rate``
    beside the usage bill's, as petals_tpu's does."""
    from petals_tpu_torch.rpc.client import RpcClient

    loop = spec_servers["loop"]
    embed = spec_servers["port"].server_gen_params["embed"].numpy()
    uids = _uids_all(model_path)
    prompt = [3, 17, 42, 5, 99]

    async def main(server):
        rpc = server.rpc_server
        host = getattr(server, "host", None) or rpc.host
        client = await RpcClient.connect(host, rpc.port)
        try:
            return [await _gen_reply(client, uids, embed, prompt, 16, s)
                    for s in (None, dict(do_sample=True, temperature=0.8, top_k=10, seed=5))]
        finally:
            await client.close()

    got = loop.run(main(spec_servers["port"]))
    want = loop.run(main(spec_servers["jax"]))
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"] and len(g["tokens"]) == 16
        meta = g["step_meta"]
        assert meta["variant"] == "prefill+gen"
        assert meta["spec_proposed"] > 0 and 0.0 <= meta["acceptance_rate"] <= 1.0
        assert meta["acceptance_rate"] == round(meta["spec_accepted"] / meta["spec_proposed"], 4)
        assert meta["usage"]["spec_proposed"] == meta["spec_proposed"]
        for key in ("spec_proposed", "spec_accepted", "acceptance_rate"):
            assert key in w["step_meta"]


def _uids_all(model_path):
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.server.server import default_dht_prefix

    prefix = default_dht_prefix(model_path)
    return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(N_LAYERS))


def test_server_announces_spec_k_and_draft_eligibility(spec_servers, model_path, tmp_path):
    """The announce's ``spec_k`` equals petals_tpu's; a draft on a server
    that cannot take one (a sub-span, the dense pool) or that fails to load
    leaves plain decode and no ``spec_k``, as petals_tpu's does."""
    from petals_tpu.data_structures import ServerState as JaxState
    from petals_tpu_torch.data_structures import ServerState
    from petals_tpu_torch.server.server import Server

    info = spec_servers["port"]._server_info(ServerState.ONLINE)
    jinfo = spec_servers["jax"]._server_info(JaxState.ONLINE)
    assert info.spec_k == jinfo.spec_k == SPEC_K
    assert info.server_gen is True
    assert spec_servers["port"].batcher.draft is not None

    async def main():
        for kw in (dict(num_blocks=2), dict(page_size=0), dict(draft_model=str(tmp_path / "missing"))):
            server = Server(model_path, device="cpu", compute_dtype=torch.float32,
                            **{**SPEC_SERVER, "draft_model": model_path, **kw})
            await server.start()
            try:
                assert server.batcher.draft is None and server._draft_model is None, kw
                assert server._server_info(ServerState.ONLINE).spec_k is None, kw
            finally:
                await server.shutdown()

    asyncio.run(asyncio.wait_for(main(), 120))


def test_cli_spec_flags_match_petals_tpu():
    """The four flags: the same names, defaults, types and choices as
    petals_tpu's CLI."""
    from petals_tpu.cli import run_server as jax_cli
    from petals_tpu_torch.cli import run_server as port_cli

    flags = ("--draft_model", "--spec_k", "--draft_window", "--draft_quant_type")

    def actions(parser):
        return {a.option_strings[0]: a for a in parser._actions if a.option_strings and a.option_strings[0] in flags}

    port, want = actions(port_cli.build_parser()), actions(jax_cli.build_parser())
    assert set(port) == set(want) == set(flags)
    for flag in flags:
        assert (port[flag].default, port[flag].choices, port[flag].type) == (
            want[flag].default, want[flag].choices, want[flag].type), flag
    assert port["--draft_quant_type"].choices == ["none", "int8", "nf4", "nf4a", "int4"]
    args = port_cli.build_parser().parse_args(["ckpt", "--draft_model", "d", "--spec_k", "3", "--draft_window", "32"])
    assert (args.draft_model, args.spec_k, args.draft_window, args.draft_quant_type) == ("d", 3, 32, "nf4a")
