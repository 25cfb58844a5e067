"""The port's intra-server tensor parallelism (petals_tpu_torch/parallel,
the TP arm of server/backend.py) against the JAX package's on the CPU,
float32, over tests/conftest.py's 8 host devices.

- The shards: ``shard_span_params`` gives, leaf by leaf, the bytes of each
  of JAX's ``addressable_shards`` after ``petals_tpu.parallel.tp.
  shard_span_params``: llama with and without biases, bloom, falcon's new
  architecture and mixtral, dense; int8 / nf4 / nf4a / int4 at widths whose
  input axes need no padding (a whole llama block at 1024 wide), and
  mixtral's int8 experts. Where the stored layout pads an input axis (to
  1024 rows), JAX's shards split the padded array; the port's hold the
  logical rows each shard multiplies (``tp.quant_leaf_specs``), checked
  against the matching rows of JAX's whole leaf.
- The refusals, with JAX's error types: indivisible kv heads, absmax
  blocks (a split that is not whole blocks in both packages' counting; the
  port also refuses a split whose logical rows are not whole blocks), the
  ``+o`` kinds, ``kv_quant_type`` with TP, and the five families without a
  spec (Mistral, Qwen2, Gemma, Gemma-2, Phi-3: a caveat of the JAX
  package, kept).
- A tp=2 backend's forward, prefill, decode and backward equal a tp=1 port
  backend and a JAX ``TransformerBackend(mesh=make_mesh((2,), ("tp",)))``
  at atol 2e-5, as tests/test_tensor_parallel.py holds JAX's own; the KV
  it writes, joined across the shards, too. Bloom at tp=4 and Mixtral are
  marked slow, as they are there.
- A quantized tp=2 backend (each shard's slice through the plain
  dequant-matmul) is held to JAX's TP path (its XLA dequant) at
  tests/test_torch_quant.py's kernel tolerance (atol 2e-2, rtol 1e-2), on a
  128-wide llama whose input-axis splits are whole absmax blocks.
- The ShardedCache reads joined and writes split, so a dense cache's bytes
  are an unsharded server's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petals_tpu.ops.quant as jq
from petals_tpu.parallel.mesh import make_mesh
from petals_tpu.parallel.tp import shard_span_params as jax_shard_span_params
from petals_tpu.parallel.tp import span_param_pspecs as jax_specs
from petals_tpu.parallel.tp import validate_tp_divisibility as jax_validate
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.parallel import collectives, tp
from petals_tpu_torch.parallel.mesh import tp_devices
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.utils.convert import block_params_from_numpy
from tests.test_torch_quant import _bits, port_leaf
from tests.utils import make_tiny_bloom, make_tiny_falcon, make_tiny_llama, make_tiny_mixtral

TOL = 2e-5
QUANT_ATOL, QUANT_RTOL = 2e-2, 1e-2  # tests/test_torch_quant.py's kernel tolerance

pytestmark = pytest.mark.timeout(600)

MAKERS = {
    "llama": lambda d: make_tiny_llama(d),
    "llama_biased": lambda d: make_tiny_llama(d, biased=True),
    "bloom": lambda d: make_tiny_bloom(d),
    "falcon_new": lambda d: make_tiny_falcon(d, variant="new"),
    "mixtral": lambda d: make_tiny_mixtral(d),
}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    return lambda name: MAKERS[name](root)


def _jax_blocks(path, dtype=jnp.float32):
    jfamily, jcfg = jax_block_config(path)
    blocks = [jax_load_block(path, i, dtype=dtype, family=jfamily, cfg=jcfg) for i in range(jcfg.num_hidden_layers)]
    return jfamily, jcfg, blocks


def _stack(blocks):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)


def _port_blocks(blocks):
    """JAX blocks carried across: quantized leaves piece by piece, dense ones
    as numpy, then as the port's tensors."""
    return [block_params_from_numpy({k: port_leaf(v) for k, v in b.items()}, "cpu", torch.float32) for b in blocks]


def _rank(index, shape, n):
    """The shard's rank along the one axis its index slices (0: replicated)."""
    for sl, size in zip(index, shape):
        if sl.start not in (None, 0) or (sl.stop not in (None, size)):
            return (sl.start or 0) // (size // n)
    return 0


def _jax_shards(arr, n):
    """{rank: numpy part} of a JAX array sharded over the mesh."""
    return {_rank(s.index, arr.shape, n): np.asarray(s.data) for s in arr.addressable_shards}


def _assert_shards_equal(jsharded, port_shards, n, padded_in=()):
    """Each leaf of each port shard, block by block, has the bytes of the
    JAX shard of the same rank (``padded_in``: leaves whose input axis the
    stored layout pads, held to the logical rows instead)."""
    for name, jleaf in jsharded.items():
        for i, shards in enumerate(port_shards):
            if isinstance(jleaf, jq.QuantizedLinear):
                for piece in ("data", "scales"):
                    jarr = getattr(jleaf, piece)
                    for rank, want in _jax_shards(jarr, n).items():
                        got = getattr(shards[rank][name], piece)
                        if name in padded_in:
                            continue  # held by _assert_logical_rows
                        np.testing.assert_array_equal(_bits(got), _bits(want[i]), err_msg=f"{name}.{piece} rank {rank}")
                assert shards[0][name].kind == jleaf.kind
            else:
                for rank, want in _jax_shards(jleaf, n).items():
                    np.testing.assert_array_equal(_bits(shards[rank][name]), _bits(want[i]), err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_dense_shards_equal_jax_addressable_shards(models, name):
    path = models(name)
    jfamily, jcfg, blocks = _jax_blocks(path)
    n = 2
    jsharded = jax_shard_span_params(_stack(blocks), make_mesh((n,), ("tp",)), jfamily.name, jcfg)
    _, cfg = get_block_config(path)
    port = tp.shard_span_params(_port_blocks(blocks), ["cpu"] * n, jfamily.name, cfg)
    assert len(port) == jcfg.num_hidden_layers and all(len(s) == n for s in port)
    _assert_shards_equal(jsharded, port, n)
    # the split leaves are copies, each contiguous, on its shard's device
    specs = tp.span_param_specs(jfamily.name, cfg)
    for shards in port:
        for leafname, axis in specs.items():
            if axis is not None:
                assert all(s[leafname].is_contiguous() for s in shards)
                assert shards[0][leafname].data_ptr() != shards[1][leafname].data_ptr()


def _wide_llama_cfg(**kw):
    from petals_tpu.models.llama.config import LlamaBlockConfig as JaxCfg
    from petals_tpu_torch.models.llama.config import LlamaBlockConfig

    base = dict(hidden_size=1024, num_attention_heads=8, num_key_value_heads=2, head_dim=128,
                intermediate_size=1024, num_hidden_layers=1, rms_norm_eps=1e-6)
    base.update(kw)
    return JaxCfg(**base), LlamaBlockConfig(**base)


def _random_jax_block(jcfg, seed):
    from petals_tpu.models.llama.block import block_param_shapes

    rng = np.random.RandomState(seed)
    return {name: jnp.asarray((rng.standard_normal(s.shape) * 0.05).astype(np.float32))
            for name, s in block_param_shapes(jcfg, jnp.float32).items()}


@pytest.mark.parametrize("kind", ["int8", "nf4", "nf4a", "int4"])
def test_quantized_shards_equal_jax_addressable_shards(kind):
    """At widths whose input axes the stored layout does not pad, every
    quantized leaf's shards (data and scales) are JAX's bytes."""
    jcfg, cfg = _wide_llama_cfg()
    block = jax_convert(_random_jax_block(jcfg, 0), "llama", kind)
    n = 2
    jsharded = jax_shard_span_params(_stack([block]), make_mesh((n,), ("tp",)), "llama", jcfg)
    port = tp.shard_span_params(_port_blocks([block]), ["cpu"] * n, "llama", cfg)
    _assert_shards_equal(jsharded, port, n)
    for leaf in ("wo", "wd"):  # input-axis splits: half the logical rows each
        assert port[0][0][leaf].in_features == block[leaf].in_features // n


@pytest.mark.parametrize("kind", ["int8", "nf4", "nf4a", "int4"])
def test_padded_input_axis_takes_the_logical_rows(kind, tmp_path):
    """A 128-wide llama (the stored layout pads every 128- and 256-row input
    axis to 1024): the output-axis splits are JAX's shards, and each
    input-axis split holds the logical rows of JAX's whole leaf, so its
    dequantization is the matching rows of the whole leaf's."""
    path = _llama128(str(tmp_path))
    jfamily, jcfg, blocks = _jax_blocks(path)
    blocks = [jax_convert(b, "llama", kind) for b in blocks]
    n = 2
    jsharded = jax_shard_span_params(_stack(blocks), make_mesh((n,), ("tp",)), "llama", jcfg)
    _, cfg = get_block_config(path)
    port = tp.shard_span_params(_port_blocks(blocks), ["cpu"] * n, "llama", cfg)
    _assert_shards_equal(jsharded, port, n, padded_in=("wo", "wd"))
    _assert_logical_rows(blocks, port, ("wo", "wd"), n)


def _assert_logical_rows(blocks, port, leaves, n):
    """Each port shard of an input-axis split dequantizes to its rows of
    the JAX whole leaf's dequantization."""
    from petals_tpu_torch.ops.quant import dequantize

    for i, b in enumerate(blocks):
        for leaf in leaves:
            whole = np.asarray(jq.dequantize(b[leaf], jnp.float32))
            rows = whole.shape[0] // n
            for rank in range(n):
                got = dequantize(port[i][rank][leaf], torch.float32).numpy()
                np.testing.assert_array_equal(got, whole[rank * rows : (rank + 1) * rows])


def test_mixtral_int8_experts_split_on_the_expert_axis(models):
    path = models("mixtral")
    jfamily, jcfg, blocks = _jax_blocks(path)
    blocks = [jax_convert(b, "mixtral", "int8") for b in blocks]
    n = 2
    jsharded = jax_shard_span_params(_stack(blocks), make_mesh((n,), ("tp",)), "mixtral", jcfg)
    _, cfg = get_block_config(path)
    port = tp.shard_span_params(_port_blocks(blocks), ["cpu"] * n, "mixtral", cfg)
    _assert_shards_equal(jsharded, port, n, padded_in=("wo",))  # 64 rows, stored padded to 1024
    _assert_logical_rows(blocks, port, ("wo",), n)
    assert port[0][0]["w1"].data.shape[0] == cfg.num_local_experts // n


# ---------------------------------------------------------------------------- refusals


def _refusal(case):
    """(JAX call, port call) for one refusal case."""
    if case == "kv_heads":
        jcfg, cfg = _wide_llama_cfg(hidden_size=128, num_attention_heads=6, num_key_value_heads=3, head_dim=16,
                                    intermediate_size=256)
        jblock = _random_jax_block(jcfg, 1)
        return (lambda: jax_shard_span_params(_stack([jblock]), make_mesh((2,), ("tp",)), "llama", jcfg),
                lambda: tp.shard_span_params(_port_blocks([jblock]), ["cpu"] * 2, "llama", cfg))
    if case == "absmax_blocks":
        # 32 shards of a 1024-row wo: 16 blocks stored and logical, in both
        # packages not a whole block a shard (JAX's check reads only the
        # mesh's axis size)
        jcfg, cfg = _wide_llama_cfg(num_attention_heads=32, num_key_value_heads=32, head_dim=32,
                                    intermediate_size=2048)
        jblock = jax_convert(_random_jax_block(jcfg, 2), "llama", "nf4")
        mesh = type("Mesh", (), {"shape": {"tp": 32}})()
        specs = jax_specs("llama", jcfg)
        return (lambda: jax_validate(_stack([jblock]), mesh, specs, num_kv_heads=32),
                lambda: tp.validate_tp_divisibility(_port_blocks([jblock]), 32, tp.span_param_specs("llama", cfg),
                                                    num_kv_heads=32))
    if case == "outlier":
        jcfg, cfg = _wide_llama_cfg()
        jblock = jax_convert(_random_jax_block(jcfg, 3), "llama", "nf4a+o")
        return (lambda: jax_shard_span_params(_stack([jblock]), make_mesh((2,), ("tp",)), "llama", jcfg),
                lambda: tp.shard_span_params(_port_blocks([jblock]), ["cpu"] * 2, "llama", cfg))
    raise ValueError(case)


@pytest.mark.parametrize("case,error,match", [
    ("kv_heads", ValueError, "not divisible"),
    ("absmax_blocks", ValueError, "absmax blocks"),
    ("outlier", NotImplementedError, "outlier"),
])
def test_refusals_raise_as_jax(case, error, match):
    jax_call, port_call = _refusal(case)
    with pytest.raises(error, match=match):
        jax_call()
    with pytest.raises(error, match=match):
        port_call()


def test_port_refuses_a_split_that_is_not_whole_logical_blocks(models):
    """Tiny llama's 64-row wo at tp=2: 32 logical rows a shard, half an
    absmax block. JAX splits its 1024-row padded storage (16 blocks) and
    takes it; a port shard multiplies its own 32 input rows, which no whole
    block covers, so the port refuses."""
    path = models("llama")
    _, _, blocks = _jax_blocks(path)
    _, cfg = get_block_config(path)
    blocks = [jax_convert(b, "llama", "nf4") for b in blocks]
    with pytest.raises(ValueError, match="absmax blocks"):
        tp.shard_span_params(_port_blocks(blocks), ["cpu"] * 2, "llama", cfg)


def test_kv_quant_type_with_tp_is_refused(models):
    path = models("llama")
    jfamily, jcfg, blocks = _jax_blocks(path)
    family, cfg = get_block_config(path)
    with pytest.raises(ValueError, match="mesh-less"):
        JaxBackend(jfamily, jcfg, _stack(blocks), first_block=0, n_blocks=len(blocks),
                   memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
                   mesh=make_mesh((2,), ("tp",)), kv_quant_type="int8")
    with pytest.raises(ValueError, match="mesh-less"):
        TransformerBackend(family, cfg, _port_blocks(blocks), first_block=0, n_blocks=len(blocks), device="cpu",
                           compute_dtype=torch.float32, tp_devices=["cpu"] * 2, kv_quant_type="int8")
    from petals_tpu_torch.server.server import Server

    with pytest.raises(ValueError, match="mesh-less"):
        Server(path, first_block=0, num_blocks=2, device="cpu", num_tp_devices=2, kv_quant_type="int8")


@pytest.mark.parametrize("family", ["mistral", "qwen2", "gemma", "gemma2", "phi3"])
def test_families_without_a_spec_raise_key_error(family):
    """The JAX package keys its specs by ``family.name``: these five have
    none (ROADMAP Queue C), and the port raises the same KeyError."""
    from petals_tpu.models import registry as jreg
    from petals_tpu_torch.models import registry as treg

    assert jreg.get_family(family).name == treg.get_family(family).name == family
    with pytest.raises(KeyError, match="No TP spec"):
        jax_specs(family, None)
    with pytest.raises(KeyError, match="No TP spec"):
        tp.span_param_specs(family, None)


def test_tp_devices_refuses_too_few_as_make_mesh():
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        make_mesh((3,), ("tp",), devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        tp_devices(3, ["cpu", "cpu"])
    assert tp_devices(2, ["cpu"] * 4) == [torch.device("cpu")] * 2
    assert tp_devices(None, ["cpu"] * 3) == [torch.device("cpu")] * 3


# ---------------------------------------------------------------------------- backends


def _backends(path, n, *, quant=None):
    """(JAX tp=n, port tp=n, port tp=1) backends over the same f32 weights."""
    jfamily, jcfg, blocks = _jax_blocks(path)
    if quant is not None:
        blocks = [jax_convert(b, jfamily.name, quant) for b in blocks]
    family, cfg = get_block_config(path)
    common = dict(first_block=0, n_blocks=len(blocks))
    jtp = JaxBackend(jfamily, jcfg, _stack(blocks), memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32,
                     use_flash=False, mesh=make_mesh((n,), ("tp",)), **common)
    qt = quant or "none"
    ttp = TransformerBackend(family, cfg, _port_blocks(blocks), device="cpu", compute_dtype=torch.float32,
                             quant_type=qt, tp_devices=["cpu"] * n, **common)
    t1 = TransformerBackend(family, cfg, _port_blocks(blocks), device="cpu", compute_dtype=torch.float32,
                            quant_type=qt, **common)
    return jtp, ttp, t1, cfg


def _run(backend, hidden, nxt, grad, jax_side=False):
    """forward, prefill, decode, the cache after them and backward of one
    backend, as numpy."""
    inp = (lambda x: x) if jax_side else torch.from_numpy
    as_np = np.asarray if jax_side else (lambda x: x.cpu().numpy())
    fwd = backend.forward(inp(hidden))
    kv = tuple(d.make_zeros() for d in backend.cache_descriptors(2, 16, 0, backend.n_blocks))
    pre, kv = backend.inference_step(inp(hidden), kv, 0)
    dec, kv = backend.inference_step(inp(nxt), kv, hidden.shape[1])
    g, _ = backend.backward(inp(hidden), inp(grad))
    return [as_np(x) for x in (fwd, pre, dec, kv[0], kv[1], g)]


def _check_backends(path, n, quant=None, atol=TOL, rtol=0):
    jtp, ttp, t1, cfg = _backends(path, n, quant=quant)
    rng = np.random.RandomState(0)
    hidden = rng.randn(2, 6, cfg.hidden_size).astype(np.float32)
    nxt = rng.randn(2, 1, cfg.hidden_size).astype(np.float32)
    grad = rng.randn(2, 6, cfg.hidden_size).astype(np.float32)
    collectives.reset_reduction_count()
    got = _run(ttp, hidden, nxt, grad)
    assert collectives.reduction_count() > 0  # the shards' partials were summed
    names = ("forward", "prefill", "decode", "k cache", "v cache", "backward")
    for name, g, w in zip(names, got, _run(t1, hidden, nxt, grad)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=f"{name} vs port tp=1")
    for name, g, w in zip(names, got, _run(jtp, hidden, nxt, grad, jax_side=True)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=f"{name} vs JAX tp={n}")
    return ttp


@pytest.mark.parametrize("name,n", [
    ("llama", 2),
    ("llama_biased", 2),
    ("falcon_new", 2),
    pytest.param("bloom", 4, marks=pytest.mark.slow),
    pytest.param("mixtral", 2, marks=pytest.mark.slow),
])
def test_tp_backend_matches_port_tp1_and_jax_tp(models, name, n):
    backend = _check_backends(models(name), n)
    assert backend.tp_size == n and backend.step_program_stats()["graph_captures"] == 0
    kd, _ = backend.cache_descriptors(2, 16, 0, backend.n_blocks)
    cache = kd.make_zeros()
    assert isinstance(cache, tp.ShardedCache) and len(cache.shards) == n
    assert cache.shards[0].shape[-2] * n == cache.shape[-2]


def _llama128(root):
    """A 2-layer llama 128 wide (4 heads of 32, 2 kv heads, FFN 256): every
    input-axis split at tp=2 is whole absmax blocks."""
    from transformers import LlamaConfig, LlamaForCausalLM

    path = os.path.join(root, "tiny-llama-128")
    if not os.path.isdir(path):
        torch.manual_seed(7)
        cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                          rms_norm_eps=1e-6, tie_word_embeddings=False)
        LlamaForCausalLM(cfg).eval().save_pretrained(path, safe_serialization=True)
    return path


@pytest.mark.parametrize("quant", ["int8", "nf4", "nf4a", "int4"])
def test_quantized_tp_backend_matches_jax_tp(quant, tmp_path):
    _check_backends(_llama128(str(tmp_path)), 2, quant=quant, atol=QUANT_ATOL, rtol=QUANT_RTOL)


def test_sharded_cache_joins_on_read_and_splits_on_write():
    rng = np.random.RandomState(3)
    whole = torch.from_numpy(rng.randn(2, 3, 5, 4, 8).astype(np.float32))
    desc = tp.ShardedDescriptor(whole.shape, torch.float32, ["cpu"] * 2)
    assert desc.nbytes == whole.numel() * 4
    cache = desc.make_zeros()
    cache.copy_(whole)
    assert [tuple(s.shape) for s in cache.shards] == [(2, 3, 5, 2, 8)] * 2
    torch.testing.assert_close(cache.cpu(), whole, rtol=0, atol=0)
    torch.testing.assert_close(cache.shards[1], whole[..., 2:, :], rtol=0, atol=0)
    view = cache[1:, :, :3]  # the leading axes index every shard, as views
    torch.testing.assert_close(view.to("cpu", copy=True), whole[1:, :, :3], rtol=0, atol=0)
    view.zero_()
    assert float(cache.join()[1:, :, :3].abs().sum()) == 0.0
    torch.testing.assert_close(cache.join()[0], whole[0], rtol=0, atol=0)
    clone = cache.clone()
    cache.zero_()
    assert float(clone.join().abs().sum()) > 0 and float(cache.join().abs().sum()) == 0.0
    with pytest.raises(IndexError):
        cache[..., 0]
    hypo = torch.tensor([2, 0, 1])
    torch.testing.assert_close(clone.index_select(1, hypo).join(), clone.join().index_select(1, hypo), rtol=0, atol=0)


def test_reduce_shards_sums_in_rank_order_and_carries_gradients():
    parts = [torch.randn(3, 4, requires_grad=True) for _ in range(3)]
    collectives.reset_reduction_count()
    out = collectives.reduce_shards(parts)
    assert collectives.reduction_count() == 1 and len(out) == 3
    torch.testing.assert_close(out[2], (parts[0] + parts[1]) + parts[2], rtol=0, atol=0)
    out[0].sum().backward()
    assert all(torch.equal(p.grad, torch.ones(3, 4)) for p in parts)
    assert collectives.reduce_shards(parts[:1])[0] is parts[0] and collectives.reduction_count() == 1
