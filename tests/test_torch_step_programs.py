"""The step programs (server/backend.py, telemetry/observatory.py) on the CPU.

- ``bucket_length`` equals the JAX package's for every chunk length up to
  10000.
- The padded mixed step, its chunk lane, position and real length given as
  tensors, against the JAX package's ``paged_mixed_step`` (which pads to the
  same bucket): decode rows, chunk rows and every page, at chunk lengths 5,
  8, 37 and 64 (buckets 8, 8, 64, 64), for a float32 pool, int8 and nf4a
  pools, and nf4a weights. Tolerances as tests/test_torch_backend.py and
  tests/test_torch_kv_quant.py state them: atol 2e-5 in float32; quantized
  pools held within one code step of JAX's; nf4a weights within 2e-2 of the
  output's largest magnitude (bf16 projections summed in another order).
  A quantized pool can also store a new row's element one code apart from
  JAX's, where the value sits on a midpoint and the two float32 projections
  round it to either side (ROADMAP's C1 is the same effect with quantized
  weights; seen here on the int8 pool at 64 rows: 5 codes of 4096 written,
  at 3 positions). Only a row that attends such a slot, in its block or
  through an earlier block's tainted rows within the sliding window, is
  held within one code step of the output's largest magnitude
  (2 * RT_BOUND); the test counts those rows, and every other row is held
  at 2e-5.
- The plain ``paged_prefill_attend`` and ``paged_update_kv`` give
  byte-identical results for host integers and 0-dim tensors.
- ``step_program_key`` tells apart everything a graph bakes in, the pools'
  addresses included, and a reset pool keeps its key.
- The CUDA path of the backend's steps, with the capture swapped for a
  stand-in that replays by re-running the captured function on the static
  buffers: byte-identical to the eager steps; one graph per bucket and pool;
  warming a pool captures every program and writes nothing, and captures
  the bucket of every chunk the batcher can hand a mixed step (a budget
  past the last bucket, a page longer than the budget).
- The observatory's counters (captures, replays, post-warm-up anomalies,
  the digest) and replay-aware launch counts, driven by the stand-in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops import paged_attention as J
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.backend import bucket_length as jax_bucket_length
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.server.backend import (
    PREFILL_BUCKETS,
    TransformerBackend,
    bucket_length,
    chunk_buckets,
    step_program_key,
)
from petals_tpu_torch.server.batching import DecodeBatcher, _LanePrefillState
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.telemetry import observatory as obs_mod
from petals_tpu_torch.telemetry.observatory import DEFAULT_WARMUP_CALLS, Observatory, TrackedGraph, count_launch
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.utils import make_tiny_mistral

N_BLOCKS = 2
L, PS, MAX_PAGES = 3, 16, 8
MAXLEN = PS * MAX_PAGES
CHUNK_POS = 16  # the chunk continues a lane that holds 16 tokens
TOL = 2e-5
QUANT_REL = 2e-2
# max |x - decode(encode(x))| over the row's absmax (tests/test_kv_quant.py)
RT_BOUND = {"int8": 0.005, "nf4a": 0.145}

jax_quantize = jax.jit(J.quantize_kv_rows, static_argnums=1)


def test_bucket_length_equals_jax():
    got = [bucket_length(n) for n in range(1, 10001)]
    assert got == [jax_bucket_length(n) for n in range(1, 10001)]


# ------------------------------------------------------------------ fixtures


def _t(a):
    """A torch copy: np.asarray of a JAX array may share its buffer, and the
    port writes its pools in place."""
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_mistral(str(tmp_path_factory.mktemp("models")), n_layers=N_BLOCKS, window=6)


_BACKENDS = {}


def _backends(model_path, weights: str, kv: str):
    """(JAX backend, port backend on the CPU) over the same float32 blocks,
    their weights quantized alike (``weights`` "none" or "nf4a", fused as a
    server serves them) and their pools encoded as ``kv`` says."""
    key = (model_path, weights, kv)
    if key not in _BACKENDS:
        from petals_tpu.utils.convert_block import convert_block_params as jax_convert
        from tests.test_torch_quant import port_leaf

        jfamily, jcfg = jax_block_config(model_path)
        per_block = [jax_load_block(model_path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg)
                     for i in range(N_BLOCKS)]
        if weights != "none":
            per_block = [jax_convert(p, jfamily.name, weights, fuse=True) for p in per_block]
        jax_backend = JaxBackend(
            jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block),
            first_block=0, n_blocks=N_BLOCKS, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32,
            use_flash=False, kv_quant_type=kv,
        )
        family, cfg = get_block_config(model_path)
        numpy_blocks = [{k: port_leaf(v) for k, v in p.items()} for p in per_block]
        backend = TransformerBackend(
            family, cfg, stacked_from_numpy(numpy_blocks, "cpu", torch.float32),
            first_block=0, n_blocks=N_BLOCKS, device="cpu", compute_dtype=torch.float32,
            quant_type=weights, kv_quant_type=kv,
        )
        _BACKENDS[key] = (jax_backend, backend, cfg)
    return _BACKENDS[key]


def _scene(rng, cfg, kv):
    """Permuted tables (lane 1 prefills at CHUNK_POS, lanes 0 and 2 decode),
    seeded pools as (JAX, port) pairs of the same bytes, and decode inputs."""
    n_pages = 12
    tables = np.full((L, MAX_PAGES), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane, need in enumerate((6, CHUNK_POS + 64, 31)):
        for s in range(-(-need // PS)):
            tables[lane, s] = free.pop()
    shape = (N_BLOCKS, n_pages, PS, cfg.num_key_value_heads, cfg.head_dim)
    jpools, tpools = [], []
    for _ in range(2):
        rows = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        if kv == "none":
            jpools.append(jnp.asarray(rows))
            tpools.append(_t(rows))
        else:
            codes, scales = jax_quantize(jnp.asarray(rows), kv)
            jpools.append(J.PagedPool(codes, scales))
            tpools.append(T.PagedPool(_t(codes), _t(scales)))
    positions = np.array([5, MAXLEN, 30], np.int32)  # lane 1 rides the decode half at the sentinel
    hidden = (rng.standard_normal((L, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    return tables, tuple(jpools), tuple(tpools), positions, hidden


def _clone_pools(pools):
    return tuple(T.PagedPool(p.codes.clone(), p.scales.clone()) if isinstance(p, T.PagedPool) else p.clone()
                 for p in pools)


def _tensors(pools):
    for p in pools:
        yield from (p if isinstance(p, T.PagedPool) else (p,))


def _close(got, want, weights, what, flip_kind=None):
    want = np.asarray(want)
    if want.size == 0:
        return
    if flip_kind is not None:
        err = np.abs(np.asarray(got) - want).max()
        assert err <= 2 * RT_BOUND[flip_kind] * np.abs(want).max(), (what, err)
    elif weights == "none":
        np.testing.assert_allclose(np.asarray(got), want, atol=TOL, rtol=0, err_msg=what)
    else:
        err = np.abs(np.asarray(got) - want).max()
        assert err <= QUANT_REL * np.abs(want).max(), (what, err)


def _flipped_slots(kv, jpools, tpools, tables):
    """Per block, per lane, the positions whose stored codes (k or v) differ
    from JAX's: a new row rounded to the other side of a midpoint."""
    out = [{lane: set() for lane in range(L)} for _ in range(N_BLOCKS)]
    if kv == "none":
        return out
    for b in range(N_BLOCKS):
        differ = np.zeros(tpools[0].codes.shape[1:3], bool)  # [n_pages, page_size]
        for jp, tp in zip(jpools, tpools):
            differ |= (tp.codes.numpy()[b] != np.asarray(jp.codes)[b]).any(axis=(2, 3))
        for lane in range(L):
            for slot, page in enumerate(tables[lane]):
                if page >= 0:
                    out[b][lane].update(slot * PS + int(i) for i in np.nonzero(differ[page])[0])
    return out


def _tainted_rows(flipped, lane, query_pos, window):
    """Which of a lane's query rows (absolute positions ``query_pos``, the
    rows this step computes) read a flipped slot: in a block, a row reads
    the K/V slots of its window, and a slot is tainted if its code flipped
    in that block or it holds a row this step computed from a tainted
    input. Rows are otherwise independent (norms, projections and the MLP
    act row by row)."""
    query_pos = list(query_pos)
    tainted = np.zeros(len(query_pos), bool)
    for block in flipped:
        kv_taint = set(block[lane]) | {p for p, t in zip(query_pos, tainted) if t}
        tainted = np.array([t or any(q - window < p <= q for p in kv_taint)
                            for q, t in zip(query_pos, tainted)], bool)
    return tainted


def _compare_pools(kv, weights, jpools, tpools):
    if kv == "none":
        for jp, tp in zip(jpools, tpools):
            _close(tp.numpy(), jp, weights, "pool")
        return
    for jp, tp in zip(jpools, tpools):
        want = np.asarray(J.dequantize_kv(jp.codes, jp.scales, kv, jnp.float32), np.float64)
        got = T.dequantize_kv(tp.codes, tp.scales, kv, torch.float32).double().numpy()
        absmax = np.abs(want).max(axis=-1, keepdims=True)
        # a flipped code moves its element by one inter-code gap: at most
        # twice the half-gap round-trip bound
        assert (np.abs(got - want) <= 2 * RT_BOUND[kv] * absmax + 1e-6).all()
        share = float((tp.codes.numpy() != np.asarray(jp.codes)).mean())
        assert share < 1e-3, share


# ------------------------------------------------------------------ the padded mixed step against JAX


@pytest.mark.parametrize("seq", [5, 8, 37, 64])
@pytest.mark.parametrize("weights,kv", [("none", "none"), ("none", "int8"), ("none", "nf4a"), ("nf4a", "none")])
def test_padded_mixed_step_matches_jax(model_path, weights, kv, seq):
    """The port's block loop on a chunk padded to its bucket, with the chunk
    lane, position and real length as tensors, against the JAX package's
    mixed step (which pads alike); the public method, given host integers,
    gives the same bytes as the tensor-fed loop."""
    jax_backend, backend, cfg = _backends(model_path, weights, kv)
    rng = np.random.default_rng(seq)
    tables, jpools, tpools, positions, hidden = _scene(rng, cfg, kv)
    chunk = (rng.standard_normal((1, seq, cfg.hidden_size)) * 0.1).astype(np.float32)

    want_dec, want_chunk, jpools = jax_backend.paged_mixed_step(hidden, jpools, positions, tables, chunk, 1, CHUNK_POS)

    bucket = bucket_length(seq)
    padded = torch.zeros(1, bucket, cfg.hidden_size)
    padded[:, :seq] = torch.from_numpy(chunk)
    lane, pos, n = torch.tensor([1], dtype=torch.int32), torch.tensor(CHUNK_POS, dtype=torch.int32), \
        torch.tensor(seq, dtype=torch.int32)
    public_pools = _clone_pools(tpools)
    got_dec, got_chunk, _ = backend._paged_mixed_eager(hidden, tpools, positions, tables, padded, lane, pos, n)
    assert got_chunk.shape == (1, bucket, cfg.hidden_size)
    _compare_pools(kv, weights, jpools, tpools)
    flipped = _flipped_slots(kv, jpools, tpools, tables)
    window = cfg.sliding_window or MAXLEN + 1
    n_flips = sum(len(block[lane]) for block in flipped for lane in range(L))
    loose = 0
    for lane_idx in (0, 2):
        taint = _tainted_rows(flipped, lane_idx, [positions[lane_idx]], window)[0]
        loose += int(taint)
        _close(got_dec.numpy()[lane_idx], np.asarray(want_dec)[lane_idx], weights, f"decode lane {lane_idx}",
               flip_kind=kv if taint else None)
    chunk_got, chunk_want = got_chunk[0, :seq].numpy(), np.asarray(want_chunk)[0]
    taint = _tainted_rows(flipped, 1, range(CHUNK_POS, CHUNK_POS + seq), window)
    loose += int(taint.sum())
    _close(chunk_got[~taint], chunk_want[~taint], weights, "chunk rows")
    _close(chunk_got[taint], chunk_want[taint], weights, "chunk rows reading a flipped code", flip_kind=kv)
    # a flipped slot reaches at most a window of rows in each block
    assert loose <= n_flips * N_BLOCKS * min(window, seq + 1), (loose, n_flips)

    dec2, chunk2, _ = backend.paged_mixed_step(hidden, public_pools, positions, tables, chunk, 1, CHUNK_POS)
    assert chunk2.shape == (1, seq, cfg.hidden_size)
    assert torch.equal(dec2, got_dec) and torch.equal(chunk2, got_chunk[:, :seq])
    for a, b in zip(_tensors(public_pools), _tensors(tpools)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ int and tensor scalars


@pytest.mark.parametrize("kv", ["none", "int8", "nf4a"])
@pytest.mark.parametrize("chunk_pos,n_valid", [(0, 13), (16, 5), (40, 16)])
def test_plain_chunk_ops_take_int_or_tensor_scalars(kv, chunk_pos, n_valid):
    rng = np.random.default_rng(chunk_pos + n_valid)
    n_pages, hkv, d, hq, seq = 10, 2, 16, 4, 16
    rows = [torch.from_numpy((rng.standard_normal((n_pages, PS, hkv, d)) * 0.5).astype(np.float32))
            for _ in range(2)]
    pools = tuple(T.PagedPool(*T.quantize_kv_rows(r, kv)) if kv != "none" else r for r in rows)
    table_row = torch.from_numpy(rng.permutation(n_pages)[:MAX_PAGES].astype(np.int32))
    table_row[6] = -1  # a hole
    k_new, v_new = (torch.from_numpy(rng.standard_normal((1, seq, hkv, d)).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((1, seq, hq, d)).astype(np.float32))

    outs = []
    for scalar in (int, lambda x: torch.tensor(x, dtype=torch.int32)):
        ps = _clone_pools(pools)
        kv_pair = (T.PagedKV(ps[0], table_row[None]), T.PagedKV(ps[1], table_row[None]))
        *_, kv_len = T.paged_update_kv(*kv_pair, k_new, v_new, scalar(chunk_pos), scalar(n_valid))
        assert int(kv_len) == chunk_pos + n_valid
        attn = T.paged_prefill_attend(q, ps[0], ps[1], table_row, scalar(chunk_pos), scalar(n_valid))
        outs.append((attn, list(_tensors(ps))))
    (a_int, p_int), (a_t, p_t) = outs
    assert torch.equal(a_int, a_t)
    assert all(torch.equal(x, y) for x, y in zip(p_int, p_t))
    # the real rows were written, the padded rows past them dropped
    for pos in range(chunk_pos, min(chunk_pos + seq, MAX_PAGES * PS)):
        page = int(table_row[pos // PS])
        if page < 0:
            continue
        same = all(torch.equal(x[page, pos % PS], y[page, pos % PS]) for x, y in zip(p_t, _tensors(pools)))
        assert same == (pos >= chunk_pos + n_valid), pos


# ------------------------------------------------------------------ the step program key


def test_step_program_key_separates_what_a_graph_bakes_in():
    k, v = torch.zeros(2, 4, 16, 2, 8), torch.zeros(2, 4, 16, 2, 8)
    base = ("mixed", 3, 8, 64, "none", "none", (k, v))
    key = step_program_key(*base)
    assert step_program_key(*base) == key
    k.zero_()  # a reset zeroes in place: the same graph
    assert step_program_key(*base) == key
    variants = [
        ("decode", 3, 8, 0, "none", "none", (k, v)),
        ("mixed", 4, 8, 64, "none", "none", (k, v)),
        ("mixed", 3, 9, 64, "none", "none", (k, v)),
        ("mixed", 3, 8, 128, "none", "none", (k, v)),
        ("mixed", 3, 8, 64, "nf4a", "none", (k, v)),
        ("mixed", 3, 8, 64, "none", "int8", (k, v)),
        ("mixed", 3, 8, 64, "none", "none", (k.clone(), v)),  # a fresh pool of the same shape
        ("mixed", 3, 8, 64, "none", "none", (v, k)),  # k and v swapped
        ("mixed", 3, 8, 64, "none", "none", (k[:, :2], v[:, :2])),  # same address, other shape
        ("mixed", 3, 8, 64, "none", "none", (k.to(torch.bfloat16), v)),
    ]
    keys = [step_program_key(*var) for var in variants]
    assert len(set(keys + [key])) == len(keys) + 1
    codes, scales = torch.zeros(2, 4, 16, 2, 8, dtype=torch.int8), torch.zeros(2, 4, 16, 2)
    qk = T.PagedPool(codes, scales)
    qkey = step_program_key("mixed", 3, 8, 64, "none", "int8", (qk, qk))
    assert qkey != step_program_key("mixed", 3, 8, 64, "none", "int8", (qk, T.PagedPool(codes, scales.clone())))


# ------------------------------------------------------------------ the capture stand-in


class StubCapture:
    """Stands in for CudaGraphCapture on the CPU: a "graph" replays by
    running the captured function again on the static inputs and copying
    its results into the static outputs; the wrappers it calls then count
    nothing, as a real replay calls no wrapper (the capture's record does)."""

    device = torch.device("cpu")

    def __init__(self):
        self.warms = 0

    def warm(self, fn, inputs):
        self.warms += 1
        fn(*inputs)

    def capture(self, fn, inputs):
        outputs = fn(*inputs)
        return StubGraph(fn, inputs, outputs), outputs


class StubGraph:
    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        obs_mod._TLS.record = []  # launches of a replay are not the wrappers'
        try:
            results = self.fn(*self.inputs)
        finally:
            obs_mod._TLS.record = None
        for out, res in zip(self.outputs, results):
            out.copy_(res)


def _stubbed(backend, capture=None):
    """A copy of ``backend`` whose steps take the card's path, replaying
    through StubCapture; and its observatory."""
    obs = Observatory()
    stub = TransformerBackend.__new__(TransformerBackend)
    stub.__dict__.update(backend.__dict__)
    capture = capture or StubCapture()
    stub._decode_program = TrackedGraph("paged_decode", capture, observatory=obs)
    stub._mixed_program = TrackedGraph("paged_mixed_step", capture, observatory=obs)
    return stub, obs


def test_graph_path_replays_equal_the_eager_steps(model_path):
    """Decode and mixed steps through the step programs (stand-in capture)
    are byte-identical to the eager steps on cloned pools; chunks of one
    bucket share a graph, a fresh pool gets its own; results are clones."""
    _, backend, cfg = _backends(model_path, "none", "int8")
    stub, obs = _stubbed(backend)
    rng = np.random.default_rng(7)
    tables, _, pools, positions, hidden = _scene(rng, cfg, "int8")
    eager_pools = _clone_pools(pools)
    steps = [("decode", None)] + [("mixed", n) for n in (5, 8, 37, 1, 64)] + [("decode", None)]
    for kind, seq in steps:
        h = (rng.standard_normal((L, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
        if kind == "decode":
            got, _ = stub.paged_decode_step(h, pools, positions, tables)
            want, _ = backend.paged_decode_step(h, eager_pools, positions, tables)
            assert torch.equal(got, want)
        else:
            chunk = (rng.standard_normal((1, seq, cfg.hidden_size)) * 0.1).astype(np.float32)
            got = stub.paged_mixed_step(h, pools, positions, tables, chunk, 1, CHUNK_POS)
            want = backend.paged_mixed_step(h, eager_pools, positions, tables, chunk, 1, CHUNK_POS)
            assert got[1].shape == (1, seq, cfg.hidden_size)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for a, b in zip(_tensors(pools), _tensors(eager_pools)):
            assert torch.equal(a, b)
        positions = positions + np.array([1, 0, 1], np.int32)
    # decode once; mixed at buckets 8 (5, 8, 1) and 64 (37, 64)
    assert (stub._decode_program.counts.captures, stub._mixed_program.counts.captures) == (1, 2)
    assert stub.step_program_stats() == {"graph_captures": 3, "graph_replays": 7, "graph_anomalies": 0}
    kept = got[1].clone()
    stub.paged_mixed_step(hidden, _clone_pools(pools), positions, tables, np.zeros((1, 64, cfg.hidden_size),
                                                                               np.float32), 1, CHUNK_POS)
    assert stub._mixed_program.counts.captures == 3  # a fresh pool: a graph of its own
    assert torch.equal(got[1], kept)  # a returned result outlives later replays
    assert obs.compile_stats()["programs"] == 4


def test_warming_a_pool_captures_every_program_and_writes_nothing(model_path):
    _, backend, cfg = _backends(model_path, "none", "nf4a")
    stub, _ = _stubbed(backend)
    _, _, pools, _, _ = _scene(np.random.default_rng(3), cfg, "nf4a")
    before = [t.clone() for t in _tensors(pools)]
    stub.warm_step_programs(pools, L, MAX_PAGES, 20)  # chunks of at most 20 tokens: buckets 8, 16, 32
    assert (stub._decode_program.counts.captures, stub._mixed_program.counts.captures) == (1, 3)
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(pools)))
    stub.warm_step_programs(pools, L, 2, 512)  # 32-token lanes: the 32 bucket holds the longest chunk
    assert (stub._decode_program.counts.captures, stub._mixed_program.counts.captures) == (2, 6)
    backend.warm_step_programs(pools, L, MAX_PAGES, 20)  # the CPU: nothing to capture
    assert backend.step_program_stats() == {"graph_captures": 0, "graph_replays": 0, "graph_anomalies": 0}


class RecordingCapture(StubCapture):
    """A stand-in that captures without running the step: its outputs are
    the static hidden and chunk buffers, its replays do nothing. For chunk
    lengths whose eager step would be too large for the CPU."""

    def warm(self, fn, inputs):
        self.warms += 1

    def capture(self, fn, inputs):
        outputs = (inputs[0].clone(),) if len(inputs) == 3 else (inputs[0].clone(), inputs[3].clone())
        return _NoReplay(), outputs


class _NoReplay:
    def replay(self):
        pass


def test_chunk_buckets_cover_every_chunk_length():
    last = PREFILL_BUCKETS[-1]
    for max_chunk in (1, 8, 9, 20, 512, last, last + 1, 2 * last, 9000, 3 * last + 5):
        want = sorted({bucket_length(n) for n in range(1, max_chunk + 1)})
        assert chunk_buckets(max_chunk) == want, max_chunk


@pytest.mark.parametrize("page_size,budget", [(64, 16), (16, 9000), (64, 512)])
def test_batcher_max_chunk_bounds_every_chunk(model_path, page_size, budget):
    """No chunk ``_next_prefill_chunk`` hands a mixed step is longer than
    ``max_chunk``, the length the batcher warms its step programs up to,
    and some chunk reaches it: a page larger than the budget lifts the
    budget to a page under decode pressure."""
    _, backend, _ = _backends(model_path, "none", "none")
    n_lanes, max_length = 4, 16384
    batcher = DecodeBatcher(backend, MemoryCache(None), PriorityTaskQueue(), n_lanes=n_lanes,
                            max_length=max_length, page_size=page_size, prefill_token_budget=budget)
    longest = 0
    for n_decode in range(n_lanes + 1):
        for position in (0, 3, page_size - 1, page_size, 5 * page_size + 7):
            for total in {1, 7, page_size + 1, budget, budget + 1, max_length - position}:
                if position + total > max_length:
                    continue
                st = _LanePrefillState(future=None, generation=0, lane=0, hidden=torch.zeros(1, total, 1),
                                       position=position, offset=0, cap=max_length, outs=[])
                batcher._prefill_queue = [st]
                _, take = batcher._next_prefill_chunk(n_decode)
                longest = max(longest, take)
    assert longest == batcher.max_chunk() == min(max(budget, page_size), batcher.max_length)


@pytest.mark.parametrize("page_size,budget", [(32, 12), (16, 9000)])
def test_warming_captures_every_bucket_the_batcher_can_reach(model_path, page_size, budget):
    """Warming a pool for a batcher's ``max_chunk`` captures the bucket of
    every chunk length up to it: past the last bucket (a budget of 9000
    tokens reaches 8192 and 12288) and when a page is longer than the
    budget (pages of 32 tokens, a budget of 12: buckets 8, 16 and 32), so
    serving captures nothing."""
    _, backend, cfg = _backends(model_path, "none", "none")
    if budget > PREFILL_BUCKETS[-1]:
        stub, _ = _stubbed(backend, RecordingCapture())
        max_pages, n_pages = 1024, 2  # a long lane; the warm-up reads and writes no page
    else:
        stub, _ = _stubbed(backend)
        max_pages, n_pages = 4, 4
    batcher = DecodeBatcher(stub, MemoryCache(None), PriorityTaskQueue(), n_lanes=L,
                            max_length=max_pages * page_size, page_size=page_size, prefill_token_budget=budget)
    shape = (N_BLOCKS, n_pages, page_size, cfg.num_key_value_heads, cfg.head_dim)
    pools = (torch.zeros(shape), torch.zeros(shape))
    stub.warm_step_programs(pools, L, batcher.max_pages, batcher.max_chunk())
    captured = sorted(key[3] for key in stub._mixed_program._entries)
    want = sorted({bucket_length(n) for n in range(1, batcher.max_chunk() + 1)})
    assert captured == want
    assert want[-1] == (12288 if budget > PREFILL_BUCKETS[-1] else 32)
    assert stub._decode_program.counts.captures == 1
    # the warm-up's captures, however many buckets, are no anomaly
    assert stub.step_program_stats()["graph_anomalies"] == 0
    assert all(not t.any() for t in pools)  # nothing written


# ------------------------------------------------------------------ the observatory


class FakeKernel:
    """A stand-in kernel wrapper with the ops' two kinds of counter."""

    def __init__(self):
        self.launches = 0
        self.kv_quant_launches = {"int8": 0, "nf4a": 0}

    def __call__(self, x):
        count_launch(self, "launches")
        count_launch(self, "kv_quant_launches", "nf4a")
        count_launch(self, "kv_quant_launches", "nf4a")
        return (x * 2,)


def test_observatory_counts_captures_replays_anomalies_and_launches():
    obs = Observatory()
    kernel = FakeKernel()
    step = TrackedGraph("step", StubCapture(), observatory=obs)
    other = TrackedGraph("step", StubCapture(), observatory=obs)  # a second backend's program of that name

    count_launch(kernel, "launches")  # no capture running: counted at once
    assert kernel.launches == 1
    (out,) = step.run("a", kernel, (torch.ones(3),))
    # the warm-up ran for real (1 + 2), the capture's launches went to its
    # record (not counted), the replay counted them (1 + 2)
    assert (kernel.launches, kernel.kv_quant_launches["nf4a"]) == (3, 4)
    assert torch.equal(out, torch.full((3,), 2.0))
    out.add_(100)  # a clone: the static output is untouched
    for i in range(2):
        (out,) = step.run("a", kernel, (torch.full((3,), float(i)),))
        assert torch.equal(out, torch.full((3,), 2.0 * i))
    assert (kernel.launches, kernel.kv_quant_launches["nf4a"]) == (5, 8)
    c = step.counts
    assert (c.calls, c.captures, c.replays, c.anomalies) == (3, 1, 3, 0) and c.capture_s >= 0

    kernel.kv_quant_launches = {"int8": 0, "nf4a": 0}  # a reset replaces the dict: replays count into the new one
    step.run("a", kernel, (torch.ones(3),))
    assert kernel.kv_quant_launches["nf4a"] == 2

    for i in range(DEFAULT_WARMUP_CALLS + 2):
        step.run(i, kernel, (torch.ones(3),))  # captures in a row (a pool's warm-up): never an anomaly
    assert (c.calls, c.captures, c.anomalies) == (DEFAULT_WARMUP_CALLS + 6, DEFAULT_WARMUP_CALLS + 3, 0)
    for _ in range(DEFAULT_WARMUP_CALLS - 3):
        step.run("a", kernel, (torch.ones(3),))  # calls that captured nothing: 3 so far, now DEFAULT_WARMUP_CALLS
    step.run("c", kernel, (torch.ones(3),))  # a capture after the warm-up's replays: an anomaly
    assert (c.captures, c.anomalies) == (DEFAULT_WARMUP_CALLS + 4, 1)
    other.run("a", kernel, (torch.ones(3),))  # warm-up is per instance
    assert (other.counts.captures, other.counts.anomalies) == (1, 0)

    digest = obs.compile_stats()
    calls = 2 * DEFAULT_WARMUP_CALLS + 5  # step's, and other's one
    assert digest == {"functions": 1, "programs": DEFAULT_WARMUP_CALLS + 5, "compile_s": digest["compile_s"],
                      "anomalies": 1, "replays": calls}
    (fn,) = obs.functions()
    assert (fn["fn"], fn["calls"], fn["captures"], fn["replays"], fn["anomalies"]) == (
        "step", calls, DEFAULT_WARMUP_CALLS + 5, calls, 1)


def test_a_failed_capture_raises_and_leaves_no_graph():
    class Failing(StubCapture):
        def capture(self, fn, inputs):
            raise RuntimeError("capture refused")

    graph = TrackedGraph("failing", Failing(), observatory=Observatory())
    with pytest.raises(RuntimeError, match="capture refused"):
        graph.run("k", lambda x: (x,), (torch.ones(2),))
    assert not graph._entries and graph.counts.captures == graph.counts.calls == 0
    assert getattr(obs_mod._TLS, "record", None) is None  # recording stopped
