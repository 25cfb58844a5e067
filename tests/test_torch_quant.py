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


@pytest.mark.parametrize("k,n,splits,per", [
    (4096, 28672, 2, 32),  # Mistral-7B wgu: 224 column slabs fill the card almost alone
    (14336, 4096, 9, 25),  # wd: 32 slabs, K split nine ways
    (4096, 4096, 8, 8),  # wo: at least 8 scale blocks per split
    (64, 128, 1, 1),
])
def test_decode_splits(k, n, splits, per):
    assert qmm.decode_splits(k, n, 132) == (splits, per)
    assert splits * per >= k // 64 > (splits - 1) * per
