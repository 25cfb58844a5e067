"""The BLOOM family in the port against petals_tpu's, on the CPU, and the
helpers the Falcon and Mixtral files share.

- ``build_alibi_slopes`` equals the JAX package's at 4, 8, 71 and 112 heads
  (112 is BLOOM-176B's, not a power of two).
- The block, loaded by each package's own loader from ``make_tiny_bloom``
  (the fused per-head QKV split at load), equals petals_tpu's
  ``block_apply`` in five cache modes (``block_parity``): no cache, a dense
  cache (a prefill, then a decode step), and paged pools in bf16, int8 and
  nf4a (a padded prefill chunk over permuted pages, then a decode step with
  an idle lane at the sentinel).
- ``apply_residual_connection_post_layernorm`` moves the output, and the
  port follows the JAX package there too.
- The client pieces (embedding LayerNorm, ``ln_f``, the tied head) equal
  the JAX package's.
- ``convert_block_params`` quantizes the leaves the JAX package quantizes,
  byte for byte, and refuses what it refuses (``quant_tables_parity``).
- A port server's greedy tokens equal a petals_tpu server's, at
  ``--quant_type none`` and ``int8``, and over a chain of one port server
  and one petals_tpu server. The backend sizes its chunks, and the
  throughput probe keys its cache, from BLOOM's config as petals_tpu does.

Tolerances (tests/test_torch_qwen2.py ``_check``): float32 atol 1e-4 (f32
matmuls and softmax summed in another order; a quantized pool's rows are
the same codes on both sides); bf16 within 2e-2 of the output's largest
magnitude (bf16 rounding at other places in the two frameworks, carried
through the block); slopes within one float32 ulp (the same powers)."""

import asyncio
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops import paged_attention as J
from petals_tpu.ops import quant as jq_mod
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.models.registry import num_kv_heads
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.ops.quant import QUANTIZED_TYPES, OutlierQuantLinear
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.utils.convert import block_params_from_numpy
from petals_tpu_torch.utils.convert_block import convert_block_params
from tests.utils import make_tiny_bloom

pytestmark = pytest.mark.timeout(300)

ATOL = 1e-4
BF16_REL = 2e-2
MODES = ("none", "dense", "paged_bf16", "paged_int8", "paged_nf4a")


def t(a):
    """A torch copy: np.asarray of a JAX array may share its buffer, and the
    port writes its caches in place."""
    return torch.from_numpy(np.array(a))


def check(got, want, bf16, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if bf16:
        err = np.abs(got - want).max()
        assert err <= BF16_REL * np.abs(want).max(), (what, err, np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


_jit_apply = {}


def jax_apply(jfamily, *args, **kwargs):
    """petals_tpu's block_apply under jit (one compile per shape: op by op
    costs seconds a call on the CPU); the config is static."""
    fn = _jit_apply.setdefault(
        jfamily.name, jax.jit(jfamily.block_apply, static_argnums=4, static_argnames=("n_valid",))
    )
    return fn(*args, **kwargs)


def both_params(np_params: dict, bf16: bool):
    """(JAX params, port params) from one dict of numpy (or carried
    quantized) leaves, floating dense leaves in float32 or bf16."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jp = {k: jnp.asarray(v, jdt if np.issubdtype(np.asarray(v).dtype, np.floating) else None)
          for k, v in np_params.items()}
    return jp, block_params_from_numpy(np_params, "cpu", tdt)


def _pools(rng, kind, n_pages, ps, hkv, d, bf16):
    """(JAX pool, port pool) pairs for k and v holding the same stale
    content: floating-point pools, or quantized PagedPools."""
    out = []
    for _ in range(2):
        rows = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
        if kind == "bf16":
            jpool = jnp.asarray(rows, jnp.bfloat16)
            out.append((jpool, t(jpool.astype(jnp.float32)).to(torch.bfloat16)))
            continue
        codes, scales = jax.jit(J.quantize_kv_rows, static_argnums=1)(jnp.asarray(rows), kind)
        out.append((J.PagedPool(codes, scales), T.PagedPool(t(codes), t(scales))))
    return out


def block_parity(jfamily, jcfg, family, cfg, np_params, mode, seed, chunk=12, n_valid=11):
    """The port's block against petals_tpu's in one cache mode (module
    docstring); ``np_params`` are the block's dense float32 leaves."""
    rng = np.random.default_rng(seed)
    hkv, d, hsz = num_kv_heads(cfg), cfg.head_dim, cfg.hidden_size
    bf16 = mode == "paged_bf16"
    jp, tp = both_params(np_params, bf16)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    x = (rng.standard_normal((1, chunk, hsz)) * 0.5).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), t(x).to(tdt)

    if mode == "none":
        jout, _ = jax_apply(jfamily, jp, xj, None, 0, jcfg)
        tout, _ = family.block_apply(tp, xt, (torch.zeros(1, chunk, hkv, d), torch.zeros(1, chunk, hkv, d)), 0, cfg)
        check(tout, jout, False, "no cache")
        return
    step = (rng.standard_normal((2, 1, hsz)) * 0.5).astype(np.float32)
    if mode == "dense":
        jkv = (jnp.zeros((1, 16, hkv, d)), jnp.zeros((1, 16, hkv, d)))
        tkv = (torch.zeros(1, 16, hkv, d), torch.zeros(1, 16, hkv, d))
        jout, jkv = jax_apply(jfamily, jp, xj, jkv, 0, jcfg)
        tout, tkv = family.block_apply(tp, xt, tkv, 0, cfg)
        check(tout, jout, False, "dense prefill")
        jout, jkv = jax_apply(jfamily, jp, jnp.asarray(step[:1]), jkv, chunk, jcfg)
        tout, tkv = family.block_apply(tp, t(step[:1]), tkv, chunk, cfg)
        check(tout, jout, False, "dense decode")
        for got, want in zip(tkv, jkv):
            check(got, want, False, "dense cache")
        return

    kind = mode.split("_")[1]
    n_pages, ps, max_pages = 12, 4, 5
    (jk, tk), (jv, tv) = _pools(rng, kind, n_pages, ps, hkv, d, bf16)
    tables = rng.permutation(n_pages)[: 2 * max_pages].astype(np.int32).reshape(2, max_pages)
    # a padded chunk at position 0 (n_valid real rows) into lane 0's pages
    jkv = (J.PagedKV(jk, jnp.asarray(tables[:1])), J.PagedKV(jv, jnp.asarray(tables[:1])))
    jout, (jk2, jv2) = jax_apply(jfamily, jp, xj, jkv, 0, jcfg, n_valid=n_valid)
    tkv = (T.PagedKV(tk, t(tables[:1])), T.PagedKV(tv, t(tables[:1])))
    tout, _ = family.block_apply(tp, xt, tkv, 0, cfg, n_valid=n_valid)
    check(tout[:, :n_valid].float(), jout[:, :n_valid], bf16, f"{mode} chunk")
    # a decode step: lane 0 after its chunk, lane 1 idle at the sentinel
    positions = np.array([n_valid, max_pages * ps], np.int32)
    jkv = (J.PagedKV(jk2.pool, jnp.asarray(tables)), J.PagedKV(jv2.pool, jnp.asarray(tables)))
    jout, (jk3, _) = jax_apply(jfamily, jp, jnp.asarray(step, jdt), jkv, jnp.asarray(positions), jcfg)
    tkv = (T.PagedKV(tk, t(tables)), T.PagedKV(tv, t(tables)))
    tout, _ = family.block_apply(tp, t(step).to(tdt), tkv, t(positions), cfg)
    check(tout[0].float(), jout[0], bf16, f"{mode} decode")
    if kind == "bf16":
        check(tk.float(), jk3.pool, True, "bf16 k pool")
    else:
        # the same rows encoded on both sides: codes may differ only where a
        # value sat on a code boundary (float32 rounding of the projection)
        same = (tk.codes.numpy() == np.asarray(jk3.pool.codes)).mean()
        assert same > 0.99, (mode, same)


def quant_tables_parity(jparams: dict, family_name: str, kinds=("int8", "nf4a")):
    """``convert_block_params`` against the JAX package's for every kind:
    the same leaves quantized, to the same bytes (an expert stack per
    expert, with the base kind); a block with no quantizable leaf refused by
    both."""
    for kind in kinds:
        jq = jax_convert(dict(jparams), family_name, kind)
        tq = convert_block_params({k: t(v) for k, v in jparams.items()}, family_name, kind)
        assert sorted(jq) == sorted(tq)
        for name, jleaf in jq.items():
            tleaf = tq[name]
            quantized = isinstance(jleaf, (jq_mod.QuantizedLinear, jq_mod.OutlierQuantLinear))
            assert quantized == isinstance(tleaf, QUANTIZED_TYPES), (kind, name)
            if not quantized:
                continue
            jin = jleaf.inner if isinstance(jleaf, jq_mod.OutlierQuantLinear) else jleaf
            tin = tleaf.inner if isinstance(tleaf, OutlierQuantLinear) else tleaf
            assert (jin.kind, tuple(jin.data.shape)) == (tin.kind, tuple(tin.data.shape)), (kind, name)
            np.testing.assert_array_equal(tin.data.numpy(), np.asarray(jin.data), err_msg=f"{kind} {name}")
            np.testing.assert_array_equal(tin.scales.float().numpy(), np.asarray(jin.scales, np.float32),
                                          err_msg=f"{kind} {name} scales")
    norms = {k: v for k, v in jparams.items() if v.ndim == 1}
    with pytest.raises(ValueError, match="no quantizable leaves"):
        jax_convert(dict(norms), family_name, "int8")
    with pytest.raises(ValueError, match="no quantizable leaves"):
        convert_block_params({k: t(v) for k, v in norms.items()}, family_name, "int8")


def loaders_agree(path, block: int = 1):
    """Each package's own loader on the checkpoint gives the same block and
    config; returns (jfamily, jcfg, family, cfg, numpy params)."""
    jfamily, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    for field in dataclasses.fields(jcfg):
        assert getattr(cfg, field.name) == getattr(jcfg, field.name), field.name
    jparams = {k: np.asarray(v) for k, v in jax_load_block(path, block, dtype=jnp.float32, family=jfamily,
                                                             cfg=jcfg).items()}
    own = load_block_params(path, block, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    assert sorted(own) == sorted(jparams)
    for name in own:  # a host-int leaf (gemma2's window) against its int32 scalar
        np.testing.assert_array_equal(np.asarray(own[name]), jparams[name], err_msg=name)
    assert {k: tuple(v.shape) for k, v in family.block_param_shapes(cfg).items()} == {
        k: v.shape for k, v in jparams.items()}
    return jfamily, jcfg, family, cfg, jparams


def client_parity(path, prompt):
    """The client pieces of both packages on the checkpoint: the embedding
    of ``prompt`` and the float32 logits of a hidden state."""
    from petals_tpu.client.from_pretrained import load_client_params as jax_load_client
    from petals_tpu_torch.client.from_pretrained import load_client_params

    jfamily, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    jc = jax_load_client(path, dtype=jnp.float32, family=jfamily, cfg=jcfg)
    tc = load_client_params(path, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    ids = np.asarray([prompt])
    emb = family.client_embed(tc, ids, cfg)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jfamily.client_embed(jc, ids, jcfg)), atol=1e-6, rtol=0)
    hidden = np.random.default_rng(3).standard_normal((1, 2, cfg.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(family.client_head(tc, t(hidden), cfg).numpy(),
                               np.asarray(jfamily.client_head(jc, jnp.asarray(hidden), jcfg)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(family.client_norm(tc, t(hidden), cfg).numpy(),
                               np.asarray(jfamily.client_norm(jc, jnp.asarray(hidden), jcfg)), atol=1e-6, rtol=0)


def _port_server(path, first, n, quant_type):
    from petals_tpu_torch.server.server import Server

    return Server(
        path, first_block=first, num_blocks=n, device="cpu", compute_dtype=torch.float32, batch_lanes=2,
        batch_max_length=128, page_size=16, prefill_token_budget=16, quant_type=quant_type, throughput=1.0,
        prefix_cache_bytes=0,
    )


def _jax_server(path, first, n, quant_type, **kw):
    from petals_tpu.server.server import Server as JaxServer

    return JaxServer(
        path, first_block=first, num_blocks=n, compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
        batching=True, batch_lanes=2, batch_max_length=128, page_size=16, prefix_cache_bytes=0,
        prefix_device_bytes=0, server_side_generation=False, quant_type=quant_type, quant_weight_cache=False,
        **kw,
    )


def greedy_streams(path, n_layers, quant_type, prompt, n_new=8, chain=False):
    """(port tokens, petals_tpu tokens): greedy streams from a port server of
    every block and from a petals_tpu server of every block; with ``chain``
    the second stream runs over a port server of the first half chained
    into a petals_tpu server of the rest (each hop a ptu.inference stream)."""
    from petals_tpu_torch.client.from_pretrained import load_client_params
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.server.server import default_dht_prefix

    family, cfg = get_block_config(path)
    client_params = load_client_params(path, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    prefix = default_dht_prefix(path)

    def uids(lo, hi):
        return CHAIN_DELIMITER.join(make_uid(prefix, i) for i in range(lo, hi))

    async def one(server, lo, hi):
        await server.start()
        host = getattr(server, "host", None) or server.rpc_server.host
        client = await RpcClient.connect(host, server.rpc_server.port)
        try:
            return await _chain_greedy([client], [uids(lo, hi)], family, cfg, client_params, prompt, n_new)
        finally:
            await client.close()
            await server.shutdown()

    async def chained():
        half = n_layers // 2
        port, jserver = _port_server(path, 0, half, quant_type), _jax_server(path, half, n_layers - half, quant_type)
        await port.start()
        await jserver.start()
        clients = [await RpcClient.connect(port.host, port.rpc_server.port),
                   await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)]
        try:
            return await _chain_greedy(clients, [uids(0, half), uids(half, n_layers)], family, cfg, client_params,
                                       prompt, n_new)
        finally:
            for c in clients:
                await c.close()
            await port.shutdown()
            await jserver.shutdown()

    async def main():
        port_tokens = await one(_port_server(path, 0, n_layers, quant_type), 0, n_layers)
        if chain:
            return port_tokens, await chained()
        return port_tokens, await one(_jax_server(path, 0, n_layers, quant_type), 0, n_layers)

    return asyncio.run(main())


async def _chain_greedy(clients, hops, family, cfg, client_params, prompt, n_new):
    """Greedy loop over raw ptu.inference streams, one a hop of a chain of
    servers, each hop's reply fed into the next; the embeddings and head
    are the port's client pieces on the CPU, the same for every server."""
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array

    streams = []
    for client, uids in zip(clients, hops):
        stream = await client.open_stream("ptu.inference")
        await stream.send({"uids": uids, "max_length": max(64, len(prompt) + n_new), "batch_size": 1})
        await stream.recv(timeout=60)
        streams.append(stream)
    tokens = list(prompt)
    hidden = family.client_embed(client_params, np.asarray([tokens]), cfg)
    for _ in range(n_new):
        for stream in streams:
            await stream.send({"tensors": {"hidden": serialize_array(hidden)}})
            hidden = deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"]).float()
        logits = family.client_head(client_params, hidden[:, -1:], cfg)[0, -1]
        tokens.append(int(torch.argmax(logits)))
        hidden = family.client_embed(client_params, np.asarray([tokens[-1:]]), cfg)
    for stream in streams:
        await stream.end()
    return tokens[len(prompt):]


def sizing_parity(path, monkeypatch, tmp_path):
    """The backend's linear chunk bound and the throughput probe's cache key
    read the family's config as petals_tpu's do: the bound equals petals_tpu's
    linear plan on the same budget, and the key's config fields are what
    petals_tpu reads (``getattr`` with its defaults)."""
    from petals_tpu.server.backend import TransformerBackend as JaxBackend
    from petals_tpu_torch.server import throughput
    from petals_tpu_torch.server.backend import TransformerBackend

    _, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    budget = 1 << 20
    backend = TransformerBackend(family, cfg, [{}], first_block=0, n_blocks=1, device="cpu",
                                 compute_dtype=torch.float32, max_chunk_size_bytes=budget)
    jbackend = types.SimpleNamespace(use_flash=True, compute_dtype=jnp.float32, hidden_size=jcfg.hidden_size,
                                     cfg=jcfg, head_dim=jcfg.head_dim, max_chunk_size_bytes=budget)
    assert backend._linear_max_chunk(1) == JaxBackend.chunk_plan(jbackend, 1, 10**6)[0]
    assert backend.num_kv_heads == (getattr(jcfg, "num_key_value_heads", None) or jcfg.num_attention_heads)

    written = {}
    monkeypatch.setattr(throughput, "measure_compute_rps", lambda *a, **k: {"inference_rps": 1.0, "forward_rps": 1.0})
    monkeypatch.setattr(throughput, "_write_cache", lambda _path, cache: written.update(cache))
    throughput.get_server_throughput(family, cfg, device="cpu", cache_dir=tmp_path, network_mbps=100.0)
    (key,) = (json.loads(k) for k in written)
    assert (key["hidden"], key["intermediate"], key["kv_heads"], key["head_dim"]) == (
        jcfg.hidden_size, getattr(jcfg, "intermediate_size", None), getattr(jcfg, "num_key_value_heads", None),
        getattr(jcfg, "head_dim", None))


# ------------------------------------------------------------------ BLOOM


@pytest.fixture(scope="module")
def bloom(tmp_path_factory):
    path = make_tiny_bloom(str(tmp_path_factory.mktemp("models")), n_layers=2)
    return (path, *loaders_agree(path))


@pytest.mark.parametrize("n_heads", [4, 8, 71, 112])
def test_alibi_slopes_match_jax(n_heads):
    from petals_tpu.ops.alibi import build_alibi_slopes as jax_slopes
    from petals_tpu_torch.ops.alibi import build_alibi_slopes

    got, want = build_alibi_slopes(n_heads).numpy(), np.asarray(jax_slopes(n_heads))
    assert got.dtype == np.float32 and got.shape == (n_heads,)
    np.testing.assert_allclose(got, want, rtol=np.finfo(np.float32).eps, atol=0)


@pytest.mark.parametrize("mode", MODES)
def test_bloom_block_matches_petals_tpu(bloom, mode):
    _, jfamily, jcfg, family, cfg, params = bloom
    assert family.name == "bloom" and num_kv_heads(cfg) == cfg.num_attention_heads
    block_parity(jfamily, jcfg, family, cfg, params, mode, seed=21)


def test_bloom_post_layernorm_residual(bloom):
    _, jfamily, _, family, cfg, params = bloom
    jcfg = dataclasses.replace(bloom[2], apply_residual_connection_post_layernorm=True)
    post = dataclasses.replace(cfg, apply_residual_connection_post_layernorm=True)
    block_parity(jfamily, jcfg, family, post, params, "dense", seed=22)
    x = t(np.random.default_rng(2).standard_normal((1, 5, cfg.hidden_size)).astype(np.float32))
    kv = lambda: (torch.zeros(1, 5, cfg.num_attention_heads, cfg.head_dim),) * 2  # noqa: E731
    a, _ = family.block_apply(block_params_from_numpy(params, "cpu", torch.float32), x, tuple(z.clone() for z in kv()), 0, cfg)
    b, _ = family.block_apply(block_params_from_numpy(params, "cpu", torch.float32), x, tuple(z.clone() for z in kv()), 0, post)
    assert (a - b).abs().max().item() > 1e-2


def test_bloom_client_pieces_match_jax(bloom):
    client_parity(bloom[0], [3, 17, 42, 5])


def test_bloom_quantization_tables_match_jax(bloom):
    quant_tables_parity(bloom[-1], "bloom")


def test_bloom_sizing_reads_the_reference_fields(bloom, monkeypatch, tmp_path):
    sizing_parity(bloom[0], monkeypatch, tmp_path)


@pytest.mark.parametrize("quant_type", ["none", "int8"])
def test_bloom_greedy_tokens_match_petals_tpu_server(bloom, quant_type):
    port, jax_tokens = greedy_streams(bloom[0], 2, quant_type, [3, 17, 42, 5, 99])
    assert port == jax_tokens


def test_bloom_mixed_chain_matches_port_server(bloom):
    port, mixed = greedy_streams(bloom[0], 2, "none", [7, 8, 9, 10], chain=True)
    assert port == mixed
