"""The port's weight quantization (petals_tpu_torch/ops/quant.py,
utils/convert_block.py) against the JAX package's on the CPU.

- Every encoder gives byte-identical codes, scales, outlier indices and
  residual rows on the same f32 and bf16 weights (a shape whose rows pad,
  a chunked encode, outlier channels with forced ties), and ``dequantize``
  is bit-equal.
- The plain ``quant_matmul`` agrees with JAX's (its CPU XLA path) within
  one bf16 ulp of each output: both round x and the dequantized weight to
  bf16 and the f32 sum once to bf16, summing in another order.
- It agrees with the JAX Pallas kernels in interpret mode at
  tests/test_quant.py's tolerance (atol 2e-2, rtol 1e-2): the decode
  kernels scale per-block partial sums instead of each weight.
- ``convert_block_params(fuse=True)`` gives the same leaves and bytes.
- A CPU tensor takes the plain version, never a kernel; a weight elsewhere
  than x raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petals_tpu.ops.quant as jq
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.ops import quant as tq
from petals_tpu_torch.ops import quant_matmul as qmm
from petals_tpu_torch.utils.convert import quant_leaf_from_numpy, tensor_from_numpy
from petals_tpu_torch.utils.convert_block import convert_block_params

KINDS = ["int8", "nf4", "nf4a", "int4", "nf4a+o", "int4+o"]


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy/jax array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return a.view(np.uint16).view(np.uint8) if a.dtype.name == "bfloat16" else a.view(np.uint8)


def _weights(rng, shape, dtype):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    return jnp.asarray(w), torch.from_numpy(w)


def _assert_same_leaf(jleaf, tleaf):
    assert jleaf.kind == tleaf.kind
    assert (jleaf.in_features, jleaf.out_features) == (tleaf.in_features, tleaf.out_features)
    jin = jleaf.inner if isinstance(jleaf, jq.OutlierQuantLinear) else jleaf
    tin = tleaf.inner if isinstance(tleaf, tq.OutlierQuantLinear) else tleaf
    np.testing.assert_array_equal(_bits(tin.data), _bits(jin.data))
    np.testing.assert_array_equal(_bits(tin.scales), _bits(jin.scales))
    assert tin.data.dtype == {"int8": torch.int8}.get(tin.kind, torch.uint8)
    if isinstance(jleaf, jq.OutlierQuantLinear):
        np.testing.assert_array_equal(tleaf.idx.numpy(), np.asarray(jleaf.idx))
        np.testing.assert_array_equal(_bits(tleaf.w_out), _bits(jleaf.w_out))
    assert tleaf.nbytes == jleaf.nbytes


def port_leaf(jleaf):
    """A JAX leaf carried across: a quantized one as a port leaf built from
    its numpy pieces, a dense one as a numpy array."""
    if not isinstance(jleaf, (jq.QuantizedLinear, jq.OutlierQuantLinear)):
        return np.asarray(jleaf)
    if isinstance(jleaf, jq.OutlierQuantLinear):
        inner = jleaf.inner
        return quant_leaf_from_numpy(
            jleaf.kind, np.asarray(inner.data), np.asarray(inner.scales), inner.in_features,
            inner.out_features, idx=np.asarray(jleaf.idx), w_out=np.asarray(jleaf.w_out),
        )
    return quant_leaf_from_numpy(
        jleaf.kind, np.asarray(jleaf.data), np.asarray(jleaf.scales), jleaf.in_features, jleaf.out_features
    )


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(192, 96), (512, 256)])  # 192 rows pad to the 1024-row k-tile
def test_quantize_is_byte_identical_and_dequantize_bit_equal(kind, dtype, shape):
    rng = np.random.default_rng(sum(shape) + len(kind))
    wj, wt = _weights(rng, shape, dtype)
    jleaf, tleaf = jq.quantize(wj, kind), tq.quantize(wt, kind)
    _assert_same_leaf(jleaf, tleaf)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = tq.dequantize(tleaf, out_dtype)
        want = jq.dequantize(jleaf, jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16)
        assert got.shape == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the leaf carried across from the JAX pieces is the same leaf
    _assert_same_leaf(jleaf, port_leaf(jleaf))


@pytest.mark.parametrize("kind", ["nf4", "nf4a", "int4"])
def test_chunked_encode_is_byte_identical(kind, monkeypatch):
    """Past _ENCODE_CHUNK_ELEMS the encode runs in column chunks (a ragged
    last chunk here) and must give the same bytes as JAX's."""
    monkeypatch.setattr(jq, "_ENCODE_CHUNK_ELEMS", 1024 * 40)
    monkeypatch.setattr(tq, "_ENCODE_CHUNK_ELEMS", 1024 * 40)
    rng = np.random.default_rng(5)
    wj, wt = _weights(rng, (256, 112), "bf16")
    _assert_same_leaf(jq.quantize(wj, kind), tq.quantize(wt, kind))


@pytest.mark.parametrize("kind", ["nf4a+o", "int4+o"])
def test_outlier_channels_break_ties_as_jax(kind):
    """bf16 checkpoints tie often: rows with equal max magnitude must give
    the same outlier channel set, lower index first."""
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((256, 64)) * 0.05).astype(np.float32)
    w[:, 0] = 0.0
    w[[3, 17, 40, 41, 100, 200, 255], 0] = 0.5  # seven rows tie for the 4 outlier slots
    w[[60, 61], 1] = -0.5
    jleaf = jq.quantize(jnp.asarray(w, jnp.bfloat16), kind)
    tleaf = tq.quantize(torch.from_numpy(w).to(torch.bfloat16), kind)
    assert tleaf.idx.tolist() == [3, 17, 40, 41]
    _assert_same_leaf(jleaf, tleaf)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [1, 8, 40])
def test_plain_quant_matmul_matches_jax_xla(kind, m):
    rng = np.random.default_rng(m + len(kind))
    wj, wt = _weights(rng, (192, 256), "f32")
    jleaf, tleaf = jq.quantize(wj, kind), tq.quantize(wt, kind)
    x = rng.standard_normal((m, 192)).astype(np.float32)
    before = {fn: dict(fn.launches) for fn in (qmm.quant_decode_matmul, qmm.quant_prefill_matmul)}
    got = tq.quant_matmul(torch.from_numpy(x), tleaf).numpy()
    want = np.asarray(jq.quant_matmul(jnp.asarray(x), jleaf))
    assert got.dtype == np.float32 and got.shape == (m, 256)
    # every output within one bf16 ulp (the +o kinds add two such roundings)
    n_ulp = 2 if kind.endswith("+o") else 1
    assert (np.abs(got - want) <= n_ulp * _bf16_ulp(want) + 1e-30).all()
    # a CPU tensor never reaches a kernel
    assert {fn: dict(fn.launches) for fn in before} == before
    # 3-D x, as the blocks call it
    got3 = tq.quant_matmul(torch.from_numpy(x).reshape(1, m, 192), tleaf)
    np.testing.assert_array_equal(got3.numpy()[0], got)


@pytest.mark.parametrize("kind", ["nf4", "nf4a", "int4", "int8"])
@pytest.mark.parametrize("m", [1, 40])  # the JAX decode (M <= 32) and prefill kernels
def test_plain_quant_matmul_matches_pallas_interpret(kind, m):
    rng = np.random.default_rng(10 + m)
    wj, wt = _weights(rng, (512, 256), "f32")
    jleaf, tleaf = jq.quantize(wj, kind), tq.quantize(wt, kind)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    kernel = jq.int8_matmul_pallas if kind == "int8" else jq.packed4_matmul_pallas
    want = np.asarray(kernel(jnp.asarray(x), jleaf, interpret=True))
    got = tq.dequant_matmul_reference(torch.from_numpy(x), tleaf).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("kind", ["nf4a", "int8", "int4+o"])
def test_convert_block_params_fused_matches_jax(kind):
    rng = np.random.default_rng(7)
    shapes = {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32), "wo": (64, 64),
              "wg": (64, 128), "wu": (64, 128), "wd": (128, 64), "ln1": (64,), "ln2": (64,)}
    dense = {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    jout = jax_convert({k: jnp.asarray(v, jnp.bfloat16) for k, v in dense.items()}, "mistral", kind, fuse=True)
    tparams = {k: tensor_from_numpy(v, "cpu", torch.bfloat16) for k, v in dense.items()}
    tout = convert_block_params(tparams, "mistral", kind, fuse=True)  # mistral resolves to llama
    assert sorted(tout) == sorted(jout) == ["ln1", "ln2", "wd", "wgu", "wo", "wqkv"]
    assert sorted(tparams) == sorted(shapes)  # the caller's dict is left as it was
    for name in ("wqkv", "wgu", "wo", "wd"):
        _assert_same_leaf(jout[name], tout[name])
    np.testing.assert_array_equal(_bits(tout["ln1"]), _bits(jout["ln1"]))
    from petals_tpu.utils.convert_block import block_size_bytes as jax_block_bytes
    from petals_tpu_torch.utils.convert_block import block_size_bytes

    assert block_size_bytes(tout) == jax_block_bytes(jout)
    assert convert_block_params(tparams, "mistral", "none") is tparams
    with pytest.raises(ValueError, match="no quantizable leaves"):
        convert_block_params({"ln1": tparams["ln1"]}, "mistral", kind)


def test_sizing_constants_match_jax():
    assert tq.BITS_PER_PARAM == jq.BITS_PER_PARAM
    assert all(tq.quantized_bytes(7 * 10**9, k) == jq.quantized_bytes(7 * 10**9, k) for k in tq.BITS_PER_PARAM)
    np.testing.assert_array_equal(tq.NF4A_CODE, jq.NF4A_CODE)
    np.testing.assert_array_equal(tq.NF4_CODE, jq.NF4_CODE)
    assert tq._TK == jq._TK and tq.NF4_BLOCK == jq.NF4_BLOCK and qmm._NF4_DECODE_MAX_M == jq._NF4_DECODE_MAX_M


def test_wrappers_dispatch_on_the_tensors_device():
    w = tq.quantize(torch.randn(128, 64), "nf4a")
    x = torch.randn(40, 128)
    np.testing.assert_array_equal(qmm.dequant_matmul(x, w).numpy(), tq.dequant_matmul_reference(x, w).numpy())
    on_meta = tq.QuantizedLinear("nf4a", w.data.to("meta"), w.scales.to("meta"), 128, 64)
    for fn in (qmm.quant_decode_matmul, qmm.quant_prefill_matmul):
        with pytest.raises(ValueError, match="one CUDA device"):
            fn(x[:4], on_meta)


MISTRAL_PROJECTIONS = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672), "wd": (14336, 4096)}


def _dealt_units(plan):
    """{(slab, scale block): block} as the decode kernel's blocks walk their runs."""
    dealt = {}
    for cta in range(plan.ctas):
        for slab, kb0, kb1 in qmm.decode_segments(plan, cta):
            assert 0 <= kb0 < kb1 <= plan.n_kb
            for kb in range(kb0, kb1):
                assert (slab, kb) not in dealt, (slab, kb)
                dealt[slab, kb] = cta
    return dealt


@pytest.mark.parametrize("k,n,slabs,n_kb,ctas", [
    (4096, 28672, 112, 64, 112),  # Mistral-7B wgu: a whole slab a block, nothing to merge
    (14336, 4096, 16, 224, 128),  # wd: each slab cut between 8 blocks of 28 scale blocks
    (4096, 4096, 16, 64, 128),  # wo: 8 blocks of 8 scale blocks a slab
    (64, 128, 1, 1, 1),  # one unit: one block
])
def test_decode_splits(k, n, slabs, n_kb, ctas):
    """The decode plan deals every (256-column slab, scale block) unit to
    exactly one block, so K is covered once in whole scale blocks; each
    block's run is contiguous in K within a slab and the runs differ by at
    most one unit; at Mistral-7B's shapes the block count is a multiple of
    the slab count, so no block cuts two slabs."""
    plan = qmm.decode_plan(8, k, n, 132)
    assert plan == qmm.decode_plan(8, k, n, 132)  # pure
    assert (plan.n_slabs, plan.n_kb, plan.ctas) == (slabs, n_kb, ctas)
    dealt = _dealt_units(plan)
    assert set(dealt) == {(s, kb) for s in range(slabs) for kb in range(n_kb)}
    sizes = [sum(kb1 - kb0 for _, kb0, kb1 in qmm.decode_segments(plan, c)) for c in range(plan.ctas)]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    for slab in range(slabs):  # the blocks the merge adds, in K order
        owners = [dealt[slab, kb] for kb in range(n_kb)]
        assert owners == sorted(owners)
        assert qmm.decode_contributors(plan, slab) == (owners[0], owners[-1])


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 32])
@pytest.mark.parametrize("kind", ["nf4a", "int8"])
@pytest.mark.parametrize("name", list(MISTRAL_PROJECTIONS))
def test_decode_plan_fills_the_card(name, kind, m):
    """At Mistral-7B's four projections at least 80% of an H100's SMs (132)
    stream, and of an H100 PCIe's (114), each block within one slab; an
    8-row tile of x per 8 rows; two rings of 2-4 stages holding 64 KB of
    weight bytes together (4-bit: 4 stages of 8 KB each; int8: 2 of 16 KB)."""
    k, n = MISTRAL_PROJECTIONS[name]
    for n_sm in (132, 114):
        plan = qmm.decode_plan(m, k, n, n_sm, kind)
        assert 0.8 * n_sm <= plan.ctas <= n_sm and plan.ctas % plan.n_slabs == 0
        assert all(len(qmm.decode_segments(plan, c)) == 1 for c in range(plan.ctas))
        assert plan.row_tiles == -(-m // 8)
        stage_bytes = (64 if kind == "int8" else 32) * 256
        assert 2 <= plan.stages <= 4 and 2 * plan.stages * stage_bytes == 64 * 1024
        assert len(_dealt_units(plan)) == plan.n_slabs * plan.n_kb


@pytest.mark.parametrize("k,n", [(4096, 92 * 256), (8192, 140 * 256), (256, 16)])
def test_decode_plan_deals_stream_k_where_slabs_do_not_fill_the_card(k, n):
    """92 slabs fill 70% of 132 SMs and 140 slabs exceed them: one block per
    SM then, whose runs may cut two slabs (both merged in K order); a shape
    with fewer units than SMs gets a block a unit."""
    plan = qmm.decode_plan(8, k, n, 132)
    units = plan.n_slabs * plan.n_kb
    assert plan.ctas == min(132, units)
    assert len(_dealt_units(plan)) == units
    for slab in range(plan.n_slabs):
        first, last = qmm.decode_contributors(plan, slab)
        assert all(any(s == slab for s, _, _ in qmm.decode_segments(plan, b)) for b in range(first, last + 1))


def test_decode_plan_refuses_what_the_kernel_does_not_take():
    for m, k in ((0, 4096), (33, 4096), (8, 100), (8, 0)):
        with pytest.raises(ValueError):
            qmm.decode_plan(m, k, 4096, 132)


@pytest.mark.parametrize("k,n", [(14336, 4096), (4096, 6144), (640, 512), (4096, 92 * 256)])
def test_decode_merge_is_the_sequential_sum_in_k_order(k, n):
    """A plain model of the kernel's in-launch merge: every block writes the
    float32 partial of each slab it cuts, the blocks arrive in any order, and
    the last to take the slab's ticket adds the partials of blocks first ..
    last in that order. Whatever the arrival order, the merged sums are bit
    for bit the float32 sum of the partials taken one after another in K
    order."""
    plan = qmm.decode_plan(8, k, n, 132)
    rng = np.random.default_rng(3)
    partial = {}  # (block, slab) -> float32 partial sums of 8 x 256
    for cta in range(plan.ctas):
        for slab, kb0, kb1 in qmm.decode_segments(plan, cta):
            if (kb0, kb1) != (0, plan.n_kb):
                partial[cta, slab] = (rng.standard_normal((8, 256)) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
    cut = sorted({slab for _, slab in partial})
    assert cut  # the shapes cut slabs between blocks
    for order in range(3):
        tickets, merged = {}, {}
        arrivals = list(partial)
        rng.shuffle(arrivals)
        for cta, slab in arrivals:
            first, last = qmm.decode_contributors(plan, slab)
            tickets[slab] = tickets.get(slab, 0) + 1
            if tickets[slab] == last - first + 1:  # the last arrival merges
                acc = np.zeros((8, 256), np.float32)
                for b in range(first, last + 1):
                    acc = acc + partial[b, slab]
                merged[slab] = acc
        assert sorted(merged) == cut
        for slab in cut:
            blocks = sorted(b for b, s in partial if s == slab)
            want = partial[blocks[0], slab].copy()
            for b in blocks[1:]:
                want = np.float32(want + partial[b, slab])
            np.testing.assert_array_equal(_bits(merged[slab]), _bits(want))


def _kernel_weights(w):
    """The decode kernel's weights, modelled: a 4-bit level split into a
    bf16 head h and a bf16 tail t (its table), and the weight round(h x s +
    round(t x s)) for the block's bf16 scale s (its two bf16x2 fmas; h x s is
    exact, the sum is taken in float64 and rounded); int8 values exactly."""
    if w.kind == "int8":
        return w.data.float()
    table = tq.code_table(w.kind)
    head = table.to(torch.bfloat16).float()
    tail = (table - head).to(torch.bfloat16).float()

    def per_weight(levels):
        pairs = torch.stack([levels[(w.data & 0x0F).long()], levels[(w.data >> 4).long()]], dim=1)
        return pairs.reshape(-1, w.out_features)[: w.in_features]

    scales = w.scales.float().repeat_interleave(64, dim=0)[: w.in_features]
    t = (per_weight(tail) * scales).to(torch.bfloat16).double()
    return (per_weight(head).double() * scales.double() + t).to(torch.bfloat16).float()


@pytest.mark.parametrize("kind", ["nf4", "nf4a", "int4", "int8"])
def test_decode_kernel_weight_rounding_model(kind):
    """Why the card check's limit holds the new decode kernel: its weights
    are the plain version's dequantize bit for bit (int4, int8 and, at these
    weights, nf4) or one bf16 ulp apart where level x scale lies next to a
    rounding boundary (nf4a: under 0.5% of the weights), so an output moves
    by far less than QUANT_REL_TOL (1e-2 of the largest output). A table of
    levels rounded to bf16 alone would move every nf4a output by ~3e-3."""
    torch.manual_seed(0)
    dense = (torch.randn(1024, 512) * 0.02).to(torch.bfloat16)
    w = tq.quantize(dense, kind)
    got, want = _kernel_weights(w), tq.dequantize(w, torch.bfloat16).float()
    if kind == "int8":  # the column scale multiplies the float32 sum instead
        want = w.data.float()
    if kind != "nf4a":
        assert torch.equal(got, want)
        return
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert ((got - want).abs() <= ulp).all() and (got != want).float().mean() < 5e-3
    x = torch.randn(8, 1024).to(torch.bfloat16).float()
    out_kernel, out_plain = x @ got, x @ want
    assert ((out_kernel - out_plain).abs().max() / out_plain.abs().max()).item() < 1e-3


def test_kernel_source_levels_match_the_plain_tables():
    """The decode kernel's level tables (csrc/quant_matmul.cu) are the plain
    version's float32 levels, bit for bit."""
    import re

    from petals_tpu_torch.kernels.build import CSRC_DIR

    src = (CSRC_DIR / "quant_matmul.cu").read_text()
    for name, table in (("NF4_CODE", tq.NF4_CODE), ("NF4A_CODE", tq.NF4A_CODE)):
        body = re.search(rf"__constant__ float {name}\[16\] = \{{(.*?)\}};", src, re.S).group(1)
        values = np.array([float(v.rstrip("f")) for v in re.findall(r"-?[0-9.]+f", body)], np.float32)
        np.testing.assert_array_equal(_bits(values), _bits(table.astype(np.float32)))
