"""The port's sequence parallelism (parallel/sp.py, ops/ring_attention.py,
``attend_maybe_ring``, the blocks' row split, the sp arm of
server/backend.py) against the JAX package's on the CPU, float32, over
tests/conftest.py's 8 host devices, at 2e-4 (tests/test_tensor_parallel.py's
own SP tolerance).

- ``ring_attend`` against the JAX ``ring_attention_sharded`` at sp 2 and 4
  (and tp 2 x sp 2), with GQA, ALiBi and a sliding window, forward and the
  gradients at q, k and v.
- Each of the four blocks under the ring (stateless) and under
  query-sharded cached prefill (a padded chunk, two distinct cache copies)
  against the JAX block with ``ring_mesh``.
- tp=1 x sp=2, tp=2 x sp=2 and tp=1 x sp=3 backends against a JAX
  ``serving_mesh`` backend: forward (the ring, and an odd length's
  fallback), backward, a padded prefill (12 -> 16 rows, at sp=3 the
  fallback) and decode, and the cache.
- One cache copy and one set of weights a distinct device.
- The refusals, type for type: Gemma-2 (ValueError), the families without
  a split at sp alone (KeyError), a fused quantized llama span at sp alone
  (KeyError), ``kv_quant_type`` with a mesh (ValueError).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops.ring_attention import ring_attention_sharded as jax_ring
from petals_tpu.parallel.mesh import make_mesh, serving_mesh
from petals_tpu.parallel.tp import shard_span_params as jax_shard_span_params
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.ops import ring_attention
from petals_tpu_torch.parallel import sp as psp
from petals_tpu_torch.parallel import tp
from petals_tpu_torch.parallel.mesh import serving_devices
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from tests.test_torch_tp import MAKERS, _jax_blocks, _port_blocks, _stack
from tests.utils import make_tiny_falcon, make_tiny_gemma, make_tiny_gemma2, make_tiny_mistral, make_tiny_phi3
from tests.utils import make_tiny_qwen2

SP_TOL = 2e-4

pytestmark = pytest.mark.timeout(600)

SP_MAKERS = dict(MAKERS, falcon_rw=lambda d: make_tiny_falcon(d, variant="rw"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    return lambda name: SP_MAKERS[name](root)


# ---------------------------------------------------------------------------- the ring


@pytest.mark.parametrize("n_tp,n_sp", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("case", ["gqa", "alibi", "window"])
def test_ring_matches_jax_ring_forward_and_gradient(n_tp, n_sp, case):
    from petals_tpu.ops.alibi import build_alibi_slopes

    rng = np.random.RandomState(n_sp + 3 * n_tp)
    b, seq, d = 2, 8 * n_sp, 16
    hq, hkv = (8, 2) if case != "alibi" else (8, 8)
    q, k, v = (rng.randn(b, seq, h, d).astype(np.float32) for h in (hq, hkv, hkv))
    w = rng.randn(b, seq, hq, d).astype(np.float32)
    slopes = np.array(build_alibi_slopes(hq)) if case == "alibi" else None
    window = 11 if case == "window" else None
    mesh = serving_mesh(n_tp, n_sp)

    def jax_loss(q_, k_, v_):
        out = jax_ring(q_, k_, v_, mesh, alibi_slopes=None if slopes is None else jnp.asarray(slopes),
                       sliding_window=window)
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    ring_attention.reset_fold_count()
    got = ring_attention.ring_attention_sharded(
        tq, tk, tv, serving_devices(n_tp, n_sp, ["cpu"] * 8), n_sp,
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes), sliding_window=window)
    assert ring_attention.fold_count() == n_tp * n_sp * n_sp  # each rank folds every block, a ring a shard
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=SP_TOL, rtol=0)
    (got * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=SP_TOL, rtol=0, err_msg=f"d{name}")


def test_ring_refuses_what_the_jax_ring_refuses():
    x = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="divide"):
        ring_attention.ring_attention_sharded(x, x, x, ["cpu"] * 4, 4)
    with pytest.raises(ValueError, match="literal 0"):
        psp.seq_ranks(2, 8, None, 4, None)
    with pytest.raises(ValueError, match="literal 0"):
        psp.seq_ranks(2, 8, None, 0, 6)
    assert psp.seq_ranks(2, 8, ("k", "v"), 4, 6) == 2 and psp.seq_ranks(2, 1, ("k", "v"), 4, None) == 1
    assert psp.seq_ranks(3, 16, ("k", "v"), 0, 12) == 1  # indivisible: rank 0 alone


# ---------------------------------------------------------------------------- the blocks


def _grid_params(block, family_name, cfg, devices):
    shards = tp.shard_span_params([block], devices[:1], family_name, cfg)[0]
    return psp.replicate_over_sp(shards, devices, len(devices))


@pytest.mark.parametrize("name", ["llama", "bloom", "falcon_new", "falcon_rw", "mixtral"])
def test_block_ring_and_query_sharded_prefill_match_jax(models, name):
    path = models(name)
    jfamily, jcfg, blocks = _jax_blocks(path)
    family, cfg = get_block_config(path)
    assert family.supports_ring_attention and jfamily.supports_ring_attention
    # two distinct cache copies: "cpu" and "cpu:0" are two devices to the grid
    devices = [torch.device("cpu"), torch.device("cpu", 0)]
    grid = _grid_params(_port_blocks(blocks[:1])[0], family.name, cfg, devices)
    assert len(grid.distinct()) == 2
    mesh = serving_mesh(1, 2)
    rng = np.random.RandomState(5)
    hidden = (rng.randn(2, 8, cfg.hidden_size) * 0.5).astype(np.float32)

    # the stateless path: the ring
    want, _ = jfamily.block_apply(blocks[0], jnp.asarray(hidden), None, 0, jcfg, ring_mesh=mesh)
    ring_attention.reset_fold_count()
    got, kv = family.block_apply(grid, torch.from_numpy(hidden), None, 0, cfg)
    assert kv is None and ring_attention.fold_count() == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SP_TOL, rtol=0)

    # the cached path: 4 rows at 0 (each rank's copy written), then 8 rows
    # at 4, query-sharded, of which 6 are real
    hkv = getattr(cfg, "num_key_value_heads", None) or getattr(cfg, "num_kv_heads", None) or cfg.num_attention_heads
    shape = (2, 16, hkv, cfg.head_dim)
    jkv = (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
    desc = tp.ShardedDescriptor((1, *shape), torch.float32, devices, num_sp=2)
    pkv = tuple(desc.make_zeros()[0] for _ in "kv")
    assert len(pkv[0].distinct()) == 2
    first = (rng.randn(2, 4, cfg.hidden_size) * 0.5).astype(np.float32)
    w1, jkv = jfamily.block_apply(blocks[0], jnp.asarray(first), jkv, 0, jcfg)
    g1, _ = family.block_apply(grid, torch.from_numpy(first), pkv, 0, cfg)
    w2, jkv = jfamily.block_apply(blocks[0], jnp.asarray(hidden), jkv, 4, jcfg, ring_mesh=mesh, n_valid=6)
    g2, _ = family.block_apply(grid, torch.from_numpy(hidden), pkv, 4, cfg, n_valid=6)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), atol=SP_TOL, rtol=0)
    np.testing.assert_allclose(g2.numpy()[:, :6], np.asarray(w2)[:, :6], atol=SP_TOL, rtol=0)
    for got_buf, want_buf in zip(pkv, jkv):
        copies = got_buf.distinct()
        np.testing.assert_array_equal(copies[0].numpy(), copies[1].numpy())  # every copy the same bytes
        np.testing.assert_allclose(got_buf.cpu().numpy(), np.asarray(want_buf), atol=SP_TOL, rtol=0)


# ---------------------------------------------------------------------------- backends


def _sp_backends(path, n_tp, n_sp):
    """(JAX serving_mesh(n_tp, n_sp), port tp x sp) backends over the same
    float32 weights."""
    jfamily, jcfg, blocks = _jax_blocks(path)
    family, cfg = get_block_config(path)
    common = dict(first_block=0, n_blocks=len(blocks))
    jax_b = JaxBackend(jfamily, jcfg, _stack(blocks), memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32,
                       use_flash=False, mesh=serving_mesh(n_tp, n_sp), **common)
    port = TransformerBackend(family, cfg, _port_blocks(blocks), device="cpu", compute_dtype=torch.float32,
                              tp_devices=["cpu"] * (n_tp * n_sp), num_sp_devices=n_sp, **common)
    return jax_b, port, cfg


def _run_sp(backend, inputs, jax_side=False):
    """forward (rows that split, then 7 that do not), backward, a padded
    prefill of 12 rows, a decode step and the cache, as numpy."""
    hidden, odd, grad, prefill, nxt = inputs
    inp = (lambda x: x) if jax_side else torch.from_numpy
    as_np = np.asarray if jax_side else (lambda x: x.cpu().numpy())
    fwd = backend.forward(inp(hidden))
    odd_fwd = backend.forward(inp(odd))
    g, _ = backend.backward(inp(hidden), inp(grad))
    kv = tuple(d.make_zeros() for d in backend.cache_descriptors(1, 32, 0, backend.n_blocks))
    pre, kv = backend.inference_step(inp(prefill), kv, 0)
    dec, kv = backend.inference_step(inp(nxt), kv, prefill.shape[1])
    return [as_np(x) for x in (fwd, odd_fwd, g, pre, dec, kv[0], kv[1])]


@pytest.mark.parametrize("name,n_tp,n_sp", [
    ("llama", 1, 2),
    ("llama", 2, 2),
    ("llama", 1, 3),
    ("llama_biased", 2, 2),
    ("bloom", 1, 2),
    ("falcon_new", 2, 2),
    ("mixtral", 1, 2),
])
def test_sp_backend_matches_jax_serving_mesh(models, name, n_tp, n_sp):
    jax_b, port, cfg = _sp_backends(models(name), n_tp, n_sp)
    assert (port.tp_size, port.sp_size, port.mesh_size) == (n_tp, n_sp, n_tp * n_sp)
    rng = np.random.RandomState(n_sp)
    h = cfg.hidden_size
    inputs = (rng.randn(2, 12, h).astype(np.float32) * 0.5, rng.randn(1, 7, h).astype(np.float32) * 0.5,
              rng.randn(2, 12, h).astype(np.float32), rng.randn(1, 12, h).astype(np.float32) * 0.5,
              rng.randn(1, 1, h).astype(np.float32) * 0.5)
    ring_attention.reset_fold_count()
    got = _run_sp(port, inputs)
    assert ring_attention.fold_count() > 0  # the forward and backward rode the ring
    want = _run_sp(jax_b, inputs, jax_side=True)
    names = ("forward", "odd forward (fallback)", "backward", "padded prefill", "decode", "k cache", "v cache")
    for what, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, atol=SP_TOL, rtol=0, err_msg=f"{what} vs JAX serving_mesh({n_tp}, {n_sp})")
    assert port.step_program_stats()["graph_captures"] == 0


def test_one_copy_a_distinct_device():
    """One card (every grid entry the same device): one set of weights and
    one cache buffer whatever sp is; two devices: a copy each."""
    from tests.utils import make_tiny_llama
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        path = make_tiny_llama(root)
        _, _, blocks = _jax_blocks(path)
        family, cfg = get_block_config(path)
        for devices, n_tp, n_sp, copies in ((["cpu"] * 4, 2, 2, 2), (["cpu"] * 2, 1, 2, 1),
                                            (["cpu", "cpu:0"], 1, 2, 2), (["cpu", "cpu:0"] * 2, 2, 2, 4)):
            backend = TransformerBackend(family, cfg, _port_blocks(blocks), first_block=0, n_blocks=len(blocks),
                                         device="cpu", compute_dtype=torch.float32, tp_devices=devices,
                                         num_sp_devices=n_sp)
            assert all(len(b.distinct()) == copies for b in backend.block_params), devices
            k, _ = backend.cache_descriptors(1, 8, 0, backend.n_blocks)
            cache = k.make_zeros()
            assert len(cache.distinct()) == copies and len(cache.ranks) == n_sp and len(cache.shards) == n_tp
            if copies == n_tp:  # shared: sp ranks hold the very same tensors
                assert all(a is b for a, b in zip(cache.ranks[0], cache.ranks[1]))
            # writes reach every copy; reads join rank 0's shards
            whole = torch.randn(cache.shape)
            cache.copy_(whole)
            for t in cache.distinct():
                assert float(t.abs().sum()) > 0
            torch.testing.assert_close(cache.clone().cpu(), whole, rtol=0, atol=0)
            torch.testing.assert_close(cache[:, :, :3].to("cpu"), whole[:, :, :3], rtol=0, atol=0)


# ---------------------------------------------------------------------------- refusals


def test_gemma2_refuses_sp_as_jax(tmp_path):
    from petals_tpu.server.server import Server as JaxServer
    from petals_tpu_torch.server.server import Server

    path = make_tiny_gemma2(str(tmp_path), n_layers=2)
    with pytest.raises(ValueError, match="needs ring attention"):
        JaxServer(path, first_block=0, num_blocks=2, num_sp_devices=2)
    with pytest.raises(ValueError, match="needs ring attention"):
        Server(path, first_block=0, num_blocks=2, device="cpu", num_sp_devices=2)


@pytest.mark.parametrize("maker", [make_tiny_mistral, make_tiny_qwen2, make_tiny_gemma, make_tiny_phi3])
def test_families_without_a_split_refuse_sp_alone_with_key_error(tmp_path, maker):
    path = maker(str(tmp_path), n_layers=2)
    jfamily, jcfg, blocks = _jax_blocks(path)
    family, cfg = get_block_config(path)
    assert family.supports_ring_attention == jfamily.supports_ring_attention is True
    with pytest.raises(KeyError, match="No TP spec"):
        JaxBackend(jfamily, jcfg, _stack(blocks), first_block=0, n_blocks=2, memory_cache=JaxMemoryCache(None),
                   compute_dtype=jnp.float32, use_flash=False, mesh=serving_mesh(1, 2))
    with pytest.raises(KeyError, match="No TP spec"):
        TransformerBackend(family, cfg, _port_blocks(blocks), first_block=0, n_blocks=2, device="cpu",
                           compute_dtype=torch.float32, tp_devices=["cpu"] * 2, num_sp_devices=2)


def test_fused_quantized_llama_at_sp_alone_raises_key_error(models):
    from petals_tpu_torch.utils.convert_block import convert_block_params

    path = models("llama")
    jfamily, jcfg, blocks = _jax_blocks(path)
    family, cfg = get_block_config(path)
    fused = [jax_convert(b, "llama", "nf4a", fuse=True) for b in blocks]
    with pytest.raises(KeyError):
        jax_shard_span_params(_stack(fused), serving_mesh(1, 2), "llama", jcfg)
    port_fused = [convert_block_params(b, "llama", "nf4a", fuse=True) for b in _port_blocks(blocks)]
    with pytest.raises(KeyError):
        TransformerBackend(family, cfg, port_fused, first_block=0, n_blocks=len(blocks), device="cpu",
                           compute_dtype=torch.float32, quant_type="nf4a", tp_devices=["cpu"] * 2,
                           num_sp_devices=2)


def test_kv_quant_type_with_sp_is_refused(models):
    path = models("llama")
    _, _, blocks = _jax_blocks(path)
    family, cfg = get_block_config(path)
    with pytest.raises(ValueError, match="mesh-less"):
        TransformerBackend(family, cfg, _port_blocks(blocks), first_block=0, n_blocks=len(blocks), device="cpu",
                           compute_dtype=torch.float32, tp_devices=["cpu"] * 2, num_sp_devices=2,
                           kv_quant_type="int8")


def test_serving_devices_orders_the_grid_as_make_mesh():
    devices = jax.devices()[:4]
    mesh = serving_mesh(2, 2, devices=devices)
    assert [d.id for d in np.asarray(mesh.devices).reshape(-1)] == [d.id for d in devices]
    names = [torch.device("cpu", i) for i in range(4)]
    assert serving_devices(2, 2, names) == names  # entry t * sp + r: shard t of rank r
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        make_mesh((2, 3), ("tp", "sp"), devices=devices)
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        serving_devices(2, 3, names)
