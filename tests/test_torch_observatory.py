"""The step-program observatory's records and costs
(petals_tpu_torch/telemetry/observatory.py, telemetry/op_cost.py) against
the JAX package's observatory and XLA's ``cost_analysis()``, on the CPU.

- (a) Single-op programs: the dispatch count of an aten op equals XLA's
  cost analysis of the jitted JAX op (flops, bytes accessed,
  transcendentals) exactly for a matmul, ``x + x``, ``exp`` and the other
  ops of ``EXACT``, over shapes and dtypes; ``DIFFER`` names each op whose
  count differs in kind and states the ratio, at one shape.
- (b) The tiny Llama span's ``paged_decode``, ``paged_mixed_step``,
  ``batched_decode`` and ``forward`` records (the card's path, through a
  stand-in capture) against the JAX backend's ``cost_table`` on the same
  checkpoint: see ``test_span_programs_cost_against_xla`` for the band and
  why.
- (c) Each kernel's cost formula, every arm and head width, against its
  closed form counted row by row, and against chip_smoke.py's own count
  where the case is at capacity.
- (d) Records, journal events and anomalies, as tests/test_telemetry.py
  holds ``tracked_jit``'s; ``max_programs``, ``reset``,
  ``PETALS_TPU_COMPILE_WARMUP``; a capture counts its cost once.
- (e) ``roofline`` and ``peak_flops``; memory analysis on request.
- (f) ``/compile`` has the JAX view's keys, and honours ``?fn=`` and
  ``?analyze=memory``.
- (h) ``SyncInferenceSession.integrity`` is the session's monitor.
"""

import json
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from petals_tpu.client.remote_sequential import SyncInferenceSession as JaxSyncSession
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.telemetry.exposition import MetricsServer as JaxMetricsServer
from petals_tpu.telemetry.observatory import get_observatory as jax_get_observatory
from petals_tpu_torch.client.remote_sequential import SyncInferenceSession
from petals_tpu_torch.ops import flash_attention as fa
from petals_tpu_torch.ops import grouped_matmul as gm
from petals_tpu_torch.ops import paged_flash_attention as pfa
from petals_tpu_torch.ops import quant_matmul as qmm
from petals_tpu_torch.ops.paged_attention import kv_wire_bytes_per_token
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.telemetry import observatory as obs_mod
from petals_tpu_torch.telemetry.exposition import MetricsServer
from petals_tpu_torch.telemetry.flight import FlightRecorder
from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.observatory import (
    DEFAULT_WARMUP_CALLS,
    MAX_PROGRAM_RECORDS,
    Observatory,
    TrackedGraph,
    count_cost,
    counting,
    get_observatory,
)
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.test_torch_dense_programs import OnceCapture
from tests.test_torch_quant import port_leaf
from tests.test_torch_step_programs import StubCapture
from tests.utils import make_tiny_llama

# ------------------------------------------------------------------ (a) single ops against XLA

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _xla(fn, *structs) -> dict:
    ca = jax.jit(fn).lower(*structs).cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return {"flops": float(ca.get("flops", 0.0) or 0.0), "bytes_accessed": float(ca.get("bytes accessed", 0.0) or 0.0),
            "transcendentals": float(ca.get("transcendentals", 0.0) or 0.0)}


def op_cost(fn, *args):
    """What ``counting`` counts for one call of ``fn(*args)``."""
    with counting() as cost:
        fn(*args)
    return cost


def _port(fn, *tensors) -> dict:
    cost = op_cost(fn, *tensors)
    assert not cost.unlisted
    return cost.total()


# name: (torch op, jax op) over one array operand, counted alike
EXACT = {
    "x + x": (lambda x: x + x, lambda x: x + x),
    "x * x": (lambda x: x * x, lambda x: x * x),
    "x - x": (lambda x: x - x, lambda x: x - x),
    "neg": (torch.neg, jnp.negative),
    "abs": (torch.abs, jnp.abs),
    "maximum": (lambda x: torch.maximum(x, x), lambda x: jnp.maximum(x, x)),
    "exp": (torch.exp, jnp.exp),
    "log": (torch.log, jnp.log),
    "tanh": (torch.tanh, jnp.tanh),
    "rsqrt": (torch.rsqrt, jax.lax.rsqrt),
    "sqrt": (torch.sqrt, jnp.sqrt),
    "erf": (torch.erf, jax.scipy.special.erf),
    "sin": (torch.sin, jnp.sin),
}
SHAPES = [(8, 16), (3, 5), (64, 33)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mkn", [(8, 8, 16), (3, 7, 5), (64, 32, 128), (1, 4096, 64)])
def test_matmul_cost_equals_xla(mkn, dtype):
    m, n, k = mkn
    tdt, jdt = DTYPES[dtype]
    got = _port(torch.matmul, torch.zeros(m, k, dtype=tdt), torch.zeros(k, n, dtype=tdt))
    want = _xla(jnp.matmul, jax.ShapeDtypeStruct((m, k), jdt), jax.ShapeDtypeStruct((k, n), jdt))
    assert got == want
    assert got["flops"] == 2 * m * n * k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_matmul_cost_equals_xla(dtype):
    tdt, jdt = DTYPES[dtype]
    got = _port(torch.bmm, torch.zeros(3, 8, 16, dtype=tdt), torch.zeros(3, 16, 4, dtype=tdt))
    want = _xla(lambda a, b: jnp.einsum("bij,bjk->bik", a, b), jax.ShapeDtypeStruct((3, 8, 16), jdt),
                jax.ShapeDtypeStruct((3, 16, 4), jdt))
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", list(EXACT))
def test_elementwise_cost_equals_xla(op, shape, dtype):
    tfn, jfn = EXACT[op]
    tdt, jdt = DTYPES[dtype]
    assert _port(tfn, torch.ones(shape, dtype=tdt)) == _xla(jfn, jax.ShapeDtypeStruct(shape, jdt))


@pytest.mark.parametrize("shape", SHAPES)
def test_cast_cost_equals_xla(shape):
    got = _port(lambda x: x.to(torch.bfloat16), torch.ones(shape))
    assert got == _xla(lambda x: x.astype(jnp.bfloat16), jax.ShapeDtypeStruct(shape, jnp.float32))


# name: (torch op, jax op, {field: port / XLA}) at [8, 16] float32. Each differs
# in kind, for the reason beside it.
DIFFER = {
    # the reduction's flops agree; XLA's reduce also reads its init constant
    # (4 bytes): 544 / 548
    "sum over the last axis": (lambda x: x.sum(-1), lambda x: x.sum(-1),
                               {"flops": 1.0, "bytes_accessed": 544 / 548, "transcendentals": 1.0}),
    # one aten op where XLA lowers a reduce and a divide, each reading and
    # writing its arrays: 544 / 680 bytes
    "mean over the last axis": (lambda x: x.mean(-1), lambda x: x.mean(-1),
                                {"flops": 1.0, "bytes_accessed": 544 / 680, "transcendentals": 1.0}),
    # aten's fused softmax counts its five steps' flops (max, subtract, exp,
    # sum, divide; 4n - 2 rows = 496) and its operand and output once; XLA
    # counts 8 more flops of its lowering and every intermediate: 1024 / 6796
    "softmax": (lambda x: torch.softmax(x, -1), lambda x: jax.nn.softmax(x, -1),
                {"flops": 496 / 504, "bytes_accessed": 1024 / 6796, "transcendentals": 1.0}),
    # sigmoid and silu: XLA's flops and transcendentals of the jax.nn
    # expansion, but one aten op's bytes: 1024 / 5636 and 1024 / 7172
    "sigmoid": (torch.sigmoid, jax.nn.sigmoid, {"flops": 1.0, "bytes_accessed": 1024 / 5636, "transcendentals": 1.0}),
    "silu": (torch.nn.functional.silu, jax.nn.silu,
             {"flops": 1.0, "bytes_accessed": 1024 / 7172, "transcendentals": 1.0}),
    # an integer power: one flop an element, as XLA's multiply, but aten's
    # pow reads x once where XLA's x * x reads it twice: 1024 / 1536
    "x ** 2": (lambda x: x**2, lambda x: x**2, {"flops": 1.0, "bytes_accessed": 1024 / 1536, "transcendentals": 1.0}),
    # a non-integer power: one transcendental an element; XLA also reads the
    # exponent, a broadcast constant: 1024 / 2052
    "x ** 2.5": (lambda x: x**2.5, lambda x: x**2.5,
                 {"flops": 1.0, "bytes_accessed": 1024 / 2052, "transcendentals": 1.0}),
    # a gather reads the rows it writes, not its whole source: 3 rows of 16
    # (192 bytes) read and written and 24 bytes of int64 indices = 408,
    # where XLA counts the source, the clamped indices and 66 index flops
    "take rows": (lambda x: x.index_select(0, torch.tensor([1, 2, 3])),
                  lambda x: jnp.take(x, jnp.array([1, 2, 3]), axis=0),
                  {"flops": 0.0, "bytes_accessed": 408 / 1527, "transcendentals": 1.0}),
}


@pytest.mark.parametrize("op", list(DIFFER))
def test_ops_that_differ_from_xla_by_their_stated_ratio(op):
    tfn, jfn, ratio = DIFFER[op]
    got = _port(tfn, torch.ones(8, 16))
    want = _xla(jfn, jax.ShapeDtypeStruct((8, 16), jnp.float32))
    for field, r in ratio.items():
        if want[field] == 0:
            assert got[field] == 0 and r == 1.0, (field, got, want)
        else:
            assert got[field] / want[field] == pytest.approx(r, rel=1e-12), (field, got, want)


def test_views_allocations_and_indexed_writes_count_what_they_move():
    """Views and allocations count nothing; an indexed write reads its
    indices and values and writes as many bytes, never its whole buffer."""
    x = torch.zeros(64, 16)
    views = op_cost(lambda: (x.view(16, 64), x.t(), x[3:9], x.unsqueeze(0).expand(2, 64, 16), torch.empty(5, 7)))
    assert views.total() == {"flops": 0.0, "bytes_accessed": 0.0, "transcendentals": 0.0}
    rows, idx = torch.ones(2, 16), torch.tensor([4, 9])
    write = op_cost(lambda: x.index_copy_(0, idx, rows))
    assert write.total() == {"flops": 0.0, "bytes_accessed": 16.0 + 2 * 128.0, "transcendentals": 0.0}
    put = op_cost(lambda: x.index_put_((idx,), rows, accumulate=True))
    assert put.total() == {"flops": 32.0, "bytes_accessed": 16.0 + 2 * 128.0, "transcendentals": 0.0}
    copy = op_cost(lambda: x[:2].copy_(rows.to(torch.bfloat16)))  # a cast (64 bytes), then the copy into a view
    assert copy.total() == {"flops": 64.0, "bytes_accessed": (128 + 64) + (64 + 128), "transcendentals": 0.0}


# ------------------------------------------------------------------ (b) the span's programs against XLA


@pytest.fixture(scope="module")
def span(tmp_path_factory):
    """(JAX backend, port backend on the CPU) over the tiny Llama
    checkpoint's 4 float32 blocks."""
    path = make_tiny_llama(str(tmp_path_factory.mktemp("models")))
    jfamily, jcfg = jax_block_config(path)
    n = jcfg.num_hidden_layers
    per_block = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(n)]
    jax_backend = JaxBackend(jfamily, jcfg, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block),
                             first_block=0, n_blocks=n, memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32,
                             use_flash=False)
    family, cfg = get_block_config(path)
    backend = TransformerBackend(family, cfg, stacked_from_numpy([{k: port_leaf(v) for k, v in p.items()}
                                                                  for p in per_block], "cpu", torch.float32),
                                 first_block=0, n_blocks=n, device="cpu", compute_dtype=torch.float32)
    return jax_backend, backend, cfg, n


PROGRAMS = {"paged_decode": ("_decode_program", True), "paged_mixed_step": ("_mixed_program", True),
            "batched_decode": ("_dense_decode_program", True), "forward": ("_forward_program", False)}


def test_span_programs_cost_against_xla(span):
    """The four programs' records on the card's path (a stand-in capture,
    so the capture's run of each step is the CPU's plain path) against the
    JAX backend's cost table, on the same inputs:

    - the dot flops equal the analytic count exactly: n_blocks x (2 x rows
      x the block's projection weights + 4 x hq x d x the (query, kv) pairs
      the plain attention scores: every slot of each lane's table, of the
      dense pool's buffer, of the chunk's table, the forward's whole square);
    - XLA counts a ``lax.scan``'s body once (HloCostAnalysis does not
      multiply by the trip count), so the JAX programs over 4 blocks count
      one block: the port's transcendentals equal n_blocks x XLA's exactly
      (the same exps, rsqrts, sines, cosines and sigmoids);
    - its flops are 0.90-1.0 of n_blocks x XLA's (measured 0.936 decode,
      0.996 mixed, 0.9995 batched, 0.998 forward): the JAX paged gather
      masks more elementwise than the port's plain path;
    - its bytes are 0.2-0.7 of n_blocks x XLA's (measured 0.263, 0.456,
      0.283, 0.573): XLA's unoptimised HLO counts every broadcast, iota
      and intermediate and the scan's slicing and stacking of the span's
      weights and pools, where the port counts eager ops (views free, a
      gather by the rows it moves, an indexed write by the rows it writes).
    """
    jax_backend, backend, cfg, n_blocks = span
    obs = Observatory()
    stub = TransformerBackend.__new__(TransformerBackend)
    stub.__dict__.update(backend.__dict__)
    capture = OnceCapture()
    for name, (attr, steady) in PROGRAMS.items():
        setattr(stub, attr, TrackedGraph(name, capture, observatory=obs, steady=steady))
    rng = np.random.default_rng(28)
    lanes, page, max_pages, dense_len, chunk, rows = 3, 16, 8, 128, 37, 64
    hkv, d, hq, h = cfg.num_key_value_heads, cfg.head_dim, cfg.num_attention_heads, cfg.hidden_size
    pools = [(rng.standard_normal((n_blocks, lanes * max_pages, page, hkv, d)) * 0.5).astype(np.float32)
             for _ in range(2)]
    dense = [(rng.standard_normal((n_blocks, lanes, dense_len, hkv, d)) * 0.5).astype(np.float32) for _ in range(2)]
    tables = np.arange(lanes * max_pages, dtype=np.int32).reshape(lanes, max_pages)
    positions = np.array([5, 40, 100], np.int32)
    mixed = positions.copy()
    mixed[1] = max_pages * page
    hidden = (rng.standard_normal((lanes, 1, h)) * 0.1).astype(np.float32)
    x_chunk = (rng.standard_normal((1, chunk, h)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, rows, h)) * 0.1).astype(np.float32)

    seen = {id(r) for r in jax_get_observatory().programs()}
    jax_backend.paged_decode_step(hidden, tuple(jnp.asarray(p) for p in pools), positions, tables)
    jax_backend.paged_mixed_step(hidden, tuple(jnp.asarray(p) for p in pools), mixed, tables, x_chunk, 1, 16)
    jax_backend.batched_decode_step(hidden, tuple(jnp.asarray(p) for p in dense), positions)
    jax_backend.forward(x)
    tp = tuple(torch.from_numpy(p.copy()) for p in pools)
    stub.paged_decode_step(hidden, tp, positions, tables)
    stub.paged_mixed_step(hidden, tp, mixed, tables, x_chunk, 1, 16)
    stub.batched_decode_step(hidden, tuple(torch.from_numpy(p.copy()) for p in dense), positions)
    stub.forward(x)
    stub.forward(x)  # a non-steady key captures on its second call
    jax_records = {r.fn: r for r in jax_get_observatory().programs() if id(r) not in seen}

    proj = sum(t.numel() for t in backend.block_params[0].values() if t.dim() == 2)
    bucket = 64  # the chunk's bucket: the step pads it
    table = max_pages * page
    dots = {
        "paged_decode": 2 * lanes * proj + 4 * hq * d * lanes * table,
        "paged_mixed_step": 2 * (lanes + bucket) * proj + 4 * hq * d * (lanes + bucket) * table,
        "batched_decode": 2 * lanes * proj + 4 * hq * d * lanes * dense_len,
        "forward": 2 * 2 * rows * proj + 4 * hq * d * 2 * rows * rows,
    }
    records = {r.fn: r for r in obs.programs()}
    assert set(records) == set(PROGRAMS) and len(obs.programs()) == 4
    for name, record in records.items():
        got = obs.analyze(record).cost
        want = jax_get_observatory().analyze(jax_records[name]).cost
        assert record.counted.part("dot")["flops"] == n_blocks * dots[name], name
        assert not record.counted.unlisted
        assert got["transcendentals"] == n_blocks * want["transcendentals"], name
        assert 0.90 <= got["flops"] / (n_blocks * want["flops"]) <= 1.0, (name, got, want)
        assert 0.2 <= got["bytes_accessed"] / (n_blocks * want["bytes_accessed"]) <= 0.7, (name, got, want)


# ------------------------------------------------------------------ (c) the kernels' formulas


def _visible_rows(first, n, kv_len, window):
    """(kv rows some query row sees, visible pairs), row by row."""
    seen, pairs = set(), 0
    for p in range(first, first + n):
        lo, hi = (0 if window is None else max(0, p - window + 1)), min(p + 1, kv_len)
        seen.update(range(lo, hi))
        pairs += max(0, hi - lo)
    return len(seen), pairs


ARMS = [("none", 2), ("none", 4), ("int8", 2), ("nf4a", 2)]  # (pool kind, q itemsize)


@pytest.mark.parametrize("window", [None, 100, 4096])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("kind,itemsize", ARMS)
def test_decode_cost_closed_form(kind, itemsize, d, window):
    lanes, hq, hkv, page, max_pages = 5, 28, 4, 64, 16
    cap = page * max_pages
    rows = lanes * _visible_rows(cap - 1, 1, cap, window)[1]
    side = {"none": hkv * d * itemsize, "int8": hkv * (d + 4), "nf4a": hkv * (d // 2 + 4)}[kind]
    want_bytes = 2 * rows * side + 2 * lanes * hq * d * itemsize + 4 * lanes * max_pages + 4 * lanes
    got = pfa.decode_cost(lanes, hq, hkv, d, page, max_pages, itemsize, kind, window)
    assert got == (4 * hq * d * rows, want_bytes, hq * rows)
    # softcap: a tanh a score more; ALiBi: the slopes read
    assert pfa.decode_cost(lanes, hq, hkv, d, page, max_pages, itemsize, kind, window, 50.0, True) == (
        got[0], got[1] + 4 * hq, 2 * hq * rows)
    if itemsize == 2:  # chip_smoke.py's own count at capacity (its pools are bf16, its pages 64 slots)
        smoke_rows = sum(chip_smoke._visible(cap - 1, cap, window) for _ in range(lanes))
        assert (got[0], got[1]) == (4 * hq * d * smoke_rows, 2 * smoke_rows * kv_wire_bytes_per_token(hkv, d, kind)
                                    + 2 * lanes * hq * d * 2 + 4 * lanes * max_pages + 4 * lanes)


@pytest.mark.parametrize("window", [None, 100, 4096])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("kind,itemsize", ARMS)
def test_prefill_cost_closed_form(kind, itemsize, d, window):
    hq, hkv, page, max_pages = 32, 8, 64, 16
    cap = page * max_pages
    for q_len in (8, 188, 512, cap):
        seen, pairs = _visible_rows(cap - q_len, q_len, cap, window)
        side = kv_wire_bytes_per_token(hkv, d, kind, itemsize)
        got = pfa.prefill_cost(q_len, hq, hkv, d, page, max_pages, itemsize, kind, window)
        assert got == (4 * hq * d * pairs, 2 * seen * side + 2 * q_len * hq * d * itemsize + 4 * max_pages + 8,
                       hq * pairs)
        if itemsize == 2:
            smoke_seen, smoke_pairs = chip_smoke._prefill_work(torch.zeros(max_pages, dtype=torch.int32),
                                                               max_pages, cap - q_len, q_len, window)
            assert (smoke_seen, smoke_pairs) == (seen, pairs)


@pytest.mark.parametrize("window", [None, 200, 4096])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_flash_cost_closed_form(itemsize, d, window):
    hq, hkv = 32, 8
    for batch, q_len, buf in ((1, 512, 2048), (2, 700, 700), (2, 333, 1000), (3, 8, 64)):
        seen, pairs = _visible_rows(buf - q_len, q_len, buf, window)
        got = fa.flash_cost(batch, q_len, hq, hkv, d, buf, itemsize, window)
        assert got == (4 * batch * hq * d * pairs,
                       batch * (2 * q_len * hq * d + 2 * seen * hkv * d) * itemsize + 8, batch * hq * pairs)
        w = window or buf
        assert pairs == chip_smoke._visible_pairs(q_len, buf - q_len, buf, w)
        assert fa.flash_cost(batch, q_len, hq, hkv, d, buf, itemsize, window, 30.0, True)[1:] == (
            got[1] + 4 * hq, 2 * got[2])


@pytest.mark.parametrize("kind", ["nf4", "nf4a", "int4", "int8"])
@pytest.mark.parametrize("m", [1, 4, 32, 64, 512])
def test_quant_matmul_cost_closed_form(kind, m):
    for k, n in ((4096, 6144), (14336, 4096), (3584, 37888)):
        weight = k * n + 4 * n if kind == "int8" else k * n // 2 + 2 * (k // 64) * n  # bytes of codes + scales
        got = qmm.quant_matmul_cost(m, k, n, kind)
        assert got == (2 * m * k * n, 2 * m * k + weight + 2 * m * n, 0)
        w = types.SimpleNamespace(in_features=k, out_features=n, kind=kind)
        nbytes, flops = chip_smoke.quant_bytes_and_flops(m, w)
        assert (got[0], got[1]) == (flops, nbytes)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_experts", [1, 4, 8])
def test_grouped_matmul_cost_closed_form(n_experts, dtype):
    item = torch.tensor([], dtype=dtype).element_size()
    for rows, k, n in ((1024, 4096, 14336), (24, 256, 384)):
        got = gm.grouped_matmul_cost(rows, k, n, n_experts, item)
        assert got == (2 * rows * k * n, item * (rows * k + n_experts * k * n + rows * n) + 4 * n_experts, 0)
        if dtype == torch.bfloat16:  # every expert used: the smoke's traffic model reads each weight once
            weights = chip_smoke.grouped_weight_traffic([1] * n_experts, k, n)["hbm_row_tiles_fastest"]
            assert got[1] == 2 * rows * k + weights + 2 * rows * n + 4 * n_experts


def test_cpu_wrappers_count_their_plain_versions_and_no_kernel():
    """On the CPU each wrapper runs its plain version, which dispatch
    counts; no kernel formula is reported, so nothing is counted twice."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 64)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((6, 16, 2, 64)).astype(np.float32))
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    positions = torch.tensor([20, 40], dtype=torch.int32)
    kv = kp[:2].reshape(1, 32, 2, 64)
    with counting() as cost:
        pfa.paged_flash_attend(q, kp, kp, tables, positions)
        fa.flash_attend(q.repeat(1, 16, 1, 1), kv, kv)
    assert set(cost.parts) == {"dot", "aten"}
    plain = op_cost(lambda: (pfa.paged_attend(q, kp, kp, tables, positions),
                             fa.flash_attend_reference(q.repeat(1, 16, 1, 1), kv, kv)))
    assert cost.parts == plain.parts
    assert cost.part("dot")["flops"] >= 4 * 8 * 64 * 2 * 48  # every slot of both lanes' tables, at least


def test_counting_one_block_of_each_signature_gives_the_whole_count(span):
    """A capture counts op by op only the first block of each signature
    (``counted_once``) and adds that count for the others: the same totals,
    by source, as counting every block's ops, and a block that differs (a
    Gemma-2 window, another shape) gets a count of its own."""
    _, backend, cfg, n_blocks = span
    rng = np.random.default_rng(5)
    pools = tuple(torch.from_numpy((rng.standard_normal((n_blocks, 12, 16, cfg.num_key_value_heads, cfg.head_dim))
                                    * 0.5).astype(np.float32)) for _ in range(2))
    tables = np.arange(12, dtype=np.int32).reshape(3, 4)
    hidden = (rng.standard_normal((3, 1, cfg.hidden_size)) * 0.1).astype(np.float32)
    positions = np.array([3, 20, 50], np.int32)
    every = TransformerBackend.__new__(TransformerBackend)
    every.__dict__.update(backend.__dict__)
    every._block_apply = backend.family.block_apply  # each block counted op by op
    obs_mod.clear_block_costs()
    with counting() as once:
        backend.paged_decode_step(hidden, pools, positions, tables)
    assert len(obs_mod._BLOCK_COSTS) == 1  # the span's 4 blocks share one signature
    with counting() as again:  # an earlier count's blocks: none counted op by op
        backend.paged_decode_step(hidden, pools, positions, tables)
    with counting() as whole:
        every.paged_decode_step(hidden, pools, positions, tables)
    assert once.parts == again.parts == whole.parts
    calls = []

    def block(params, h, scale):
        calls.append(scale)
        return h * scale
    counted = obs_mod.counted_once(block)
    with counting() as cost:
        for scale in (2, 2, 3):
            counted({"w": torch.ones(2)}, torch.ones(4, 4), scale)
        counted({"w": torch.ones(2)}, torch.ones(4, 8), 2)
    assert cost.part("aten")["flops"] == 16 * 3 + 32 and len(calls) == 4


class _Kernel:
    """A stand-in wrapper: a glue op, then a launch that reports its cost."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        y = x * 2  # glue: dispatch counts it
        obs_mod.count_launch(self, "launches")
        count_cost("fake_kernel", lambda n: (10 * n, 100 * n, n), x.numel())
        return (y,)


def test_a_capture_counts_each_kernel_by_its_formula_once():
    obs = Observatory()
    kernel = _Kernel()
    count_cost("fake_kernel", lambda: pytest.fail("a cost computed outside a count"))
    graph = TrackedGraph("fake_step", StubCapture(), observatory=obs)
    for _ in range(3):
        graph.run("k", kernel, (torch.ones(4),))
    (record,) = obs.programs()
    assert record.counted.parts == {"fake_kernel": [40, 400, 4], "aten": [4, 32, 0]}  # the capture's run only
    assert obs.analyze(record).cost == {"flops": 44.0, "bytes_accessed": 432.0, "transcendentals": 4.0}
    assert kernel.launches == 1 + 3  # the warm-up, then three replays


# ------------------------------------------------------------------ (d) records, events, anomalies


def test_captures_are_recorded_journaled_and_anomalies_flight_recorded():
    """As tests/test_telemetry.py holds ``tracked_jit``: one compile event
    a capture with its avals; past warm-up, a new shape is one
    compile_anomaly and one recompile entry whose evidence is the journal's
    compile tail; the records carry the JAX package's fields."""
    obs = Observatory(warmup_calls=2)
    flight = FlightRecorder(cooldown_s=0.0)
    obs.attach_flight(flight)
    assert obs.flight_recorder() is flight
    toy = TrackedGraph("toy", StubCapture(), observatory=obs)
    seq0 = get_journal().seq
    a = torch.ones(4, 4)
    for _ in range(3):
        toy.run(("a",), lambda x, y: (x + y,), (a, a))
    stats = obs.compile_stats()
    assert stats == {"functions": 1, "programs": 1, "compile_s": stats["compile_s"], "anomalies": 0, "replays": 3}
    compiles = get_journal().events(kind="compile", since_seq=seq0)
    assert len(compiles) == 1 and compiles[0]["fn"] == "toy" and compiles[0]["avals"] == ["float32[4,4]"] * 2
    assert compiles[0]["compiles"] == 1 and compiles[0]["steady"] is True and compiles[0]["key"] == "('a',)"
    (record,) = obs.programs()
    want_keys = {"fn", "steady", "key", "avals", "n_leaves", "arg_bytes", "compile_s", "t", "anomaly"}
    assert set(record.as_dict()) == want_keys
    assert (record.n_leaves, record.arg_bytes, record.anomaly) == (2, 128, False)

    b = torch.ones(2, 2, dtype=torch.bfloat16)
    toy.run(("b",), lambda x, y: (x + y,), (b, b))
    anomalies = get_journal().events(kind="compile_anomaly", since_seq=seq0)
    assert len(anomalies) == 1 and anomalies[0]["fn"] == "toy" and anomalies[0]["warmup_calls"] == 2
    assert anomalies[0]["avals"] == ["bfloat16[2,2]"] * 2
    entries = flight.entries(kind="recompile")
    assert len(entries) == 1 and entries[0]["fn"] == "toy"
    assert entries[0]["server_journal"] and all(e["kind"] == "compile" for e in entries[0]["server_journal"])
    assert obs.compile_stats()["anomalies"] == 1 and obs.programs()[-1].anomaly is True

    # the JAX package's record and digest carry the same field names
    from petals_tpu.telemetry.observatory import ProgramRecord as JaxRecord

    assert set(JaxRecord.__slots__) - {"_structs", "_lower"} <= set(type(record).__slots__)
    assert set(obs_mod.compile_stats_digest()) >= {"functions", "programs", "compile_s", "anomalies"}


def test_avals_are_capped_as_the_jax_package_caps_them():
    obs = Observatory()
    wide = TrackedGraph("wide", StubCapture(), observatory=obs)
    inputs = tuple(torch.zeros(i + 1) for i in range(30))
    wide.run(0, lambda *xs: (xs[0] + 1,), inputs)
    (record,) = obs.programs()
    assert record.n_leaves == 30 and len(record.avals) == 25
    assert record.avals[:2] == ["float32[1]", "float32[2]"] and record.avals[-1] == "... +6 more"


def test_max_programs_keeps_the_newest_and_reset_drops_everything():
    obs = Observatory(max_programs=3)
    graph = TrackedGraph("many", StubCapture(), observatory=obs)
    for i in range(5):
        graph.run(i, lambda x: (x * 2,), (torch.ones(i + 1),))
    assert [r.key for r in obs.programs()] == ["2", "3", "4"] and obs.dropped_programs == 2
    assert obs.compile_stats()["programs"] == 5
    obs.reset()
    assert obs.programs() == [] and obs.dropped_programs == 0 and obs.functions() == []
    assert Observatory().max_programs == MAX_PROGRAM_RECORDS


def test_warmup_calls_come_from_the_environment(monkeypatch):
    monkeypatch.setenv("PETALS_TPU_COMPILE_WARMUP", "3")
    obs = Observatory()
    assert obs.warmup_calls == 3
    graph = TrackedGraph("warm3", StubCapture(), observatory=obs)
    for _ in range(4):  # one capture, three replays of it
        graph.run("a", lambda x: (x + 1,), (torch.ones(2),))
    graph.run("b", lambda x: (x + 1,), (torch.ones(3),))
    assert graph.counts.anomalies == 1
    monkeypatch.setenv("PETALS_TPU_COMPILE_WARMUP", "not a number")
    assert Observatory().warmup_calls == DEFAULT_WARMUP_CALLS
    monkeypatch.setenv("PETALS_TPU_COMPILE_WARMUP", "0")
    assert Observatory().warmup_calls == 1


def test_a_capture_without_counting_has_no_cost():
    obs = Observatory(count_costs=False)
    graph = TrackedGraph("uncounted", StubCapture(), observatory=obs)
    graph.run(0, lambda x: (x @ x,), (torch.ones(4, 4),))
    (record,) = obs.programs()
    assert record.counted is None and "error" in obs.analyze(record).cost


# ------------------------------------------------------------------ (e) roofline, peak, memory


def test_cost_table_roofline_and_memory(monkeypatch):
    monkeypatch.delenv("PETALS_TPU_PEAK_TFLOPS", raising=False)
    obs = Observatory()
    mm = TrackedGraph("mm", StubCapture(), observatory=obs)
    x = torch.ones(8, 16)
    mm.run(0, lambda a, b: (a @ b,), (x, torch.ones(16, 8)))
    table = obs.cost_table()
    assert len(table) == 1 and "memory" not in table[0]
    cost = table[0]["cost"]
    assert cost == {"flops": 2048.0, "bytes_accessed": 1280.0, "transcendentals": 0.0}  # XLA's, above

    r = obs.roofline("mm", 0.001)
    assert r == {"fn": "mm", "flops_per_step": 2048.0, "step_mean_ms": 1.0, "achieved_gflops": 0.002,
                 "utilization": None}
    assert Observatory.peak_flops() is None
    monkeypatch.setenv("PETALS_TPU_PEAK_TFLOPS", "0.000001")
    assert Observatory.peak_flops() == pytest.approx(1e6)
    assert obs.roofline("mm", 0.001)["utilization"] == pytest.approx(2.048)
    monkeypatch.setenv("PETALS_TPU_PEAK_TFLOPS", "fast")
    assert Observatory.peak_flops() is None
    assert obs.roofline("mm", 0.0) is None and obs.roofline("absent", 0.001) is None

    mem = obs.cost_table(memory=True)[0]["memory"]
    assert mem == {"temp_bytes": None, "argument_bytes": 1024, "output_bytes": 256, "code_bytes": 0}  # no card
    obs.reset()
    nothing = TrackedGraph("copy", StubCapture(), observatory=obs)
    nothing.run(0, lambda a: (a.clone(),), (torch.ones(3),))
    assert obs.roofline("copy", 0.001) is None  # no flops to divide


def test_analyze_sets_the_program_gauges():
    from petals_tpu_torch.telemetry import instruments as tm

    obs = Observatory()
    TrackedGraph("gauged", StubCapture(), observatory=obs).run(0, lambda a: (a @ a,), (torch.ones(4, 4),))
    obs.cost_table(fn="gauged")
    assert tm.COMPILED_FLOPS.labels(fn="gauged").value == 128.0
    assert tm.COMPILED_BYTES.labels(fn="gauged").value == 192.0


# ------------------------------------------------------------------ (f) /compile


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def test_compile_view_has_the_jax_views_keys():
    graph = TrackedGraph("compile_view_step", StubCapture())  # the process's observatory
    graph.run(0, lambda a: (a @ a,), (torch.ones(4, 4),))
    graph.run(1, lambda a: (a @ a,), (torch.ones(2, 2),))
    port_server, jax_server = MetricsServer(), JaxMetricsServer()
    try:
        view = _get(port_server.port, "/compile")
        # the JAX view, scoped to no program (a full scrape would re-lower them all)
        jax_view = _get(jax_server.port, "/compile?fn=no_such_program")
        assert set(view) == set(jax_view) == {"warmup_calls", "stats", "functions", "programs", "dropped_programs"}
        assert view["warmup_calls"] == get_observatory().warmup_calls
        mine = _get(port_server.port, "/compile?fn=compile_view_step")["programs"]
        assert [p["avals"] for p in mine] == [["float32[4,4]"], ["float32[2,2]"]]
        assert [p["cost"]["flops"] for p in mine] == [128.0, 16.0] and all("memory" not in p for p in mine)
        for analyze in ("memory", "1"):
            mem = _get(port_server.port, f"/compile?fn=compile_view_step&analyze={analyze}")["programs"]
            assert mem[0]["memory"] == {"temp_bytes": None, "argument_bytes": 64, "output_bytes": 64, "code_bytes": 0}
        assert any(f["fn"] == "compile_view_step" and f["captures"] == 2 for f in view["functions"])
    finally:
        port_server.close()
        jax_server.close()


# ------------------------------------------------------------------ (h) the sync session's monitor


def test_sync_session_integrity_is_the_sessions_monitor():
    from petals_tpu_torch.telemetry.integrity import IntegrityMonitor

    session = types.SimpleNamespace(integrity=IntegrityMonitor())
    assert SyncInferenceSession(session, runtime=None).integrity is session.integrity
    assert isinstance(JaxSyncSession.integrity, property) and isinstance(SyncInferenceSession.integrity, property)
