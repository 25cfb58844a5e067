"""The Qwen2 family in the port against petals_tpu's, on the CPU in f32.

- The port's llama block under ``qkv_bias`` (bias on q, k and v, none on o)
  equals petals_tpu's on ``make_tiny_qwen2``'s weights, with the q/k/v
  projections separate and fused (``wqkv``/``bqkv``), in float32 and with
  nf4a weights (the bias added after the dequant-matmul).
- The same at a GQA group of 7 (7 query heads over 1 kv head, Qwen2.5-7B's
  28 over 4), weights drawn with numpy and fed through both packages'
  configs.
- ``use_sliding_window=True`` is refused at load, as petals_tpu refuses it.
- A1's gate: a port server's greedy tokens equal a petals_tpu server's on
  ``make_tiny_qwen2`` (tied embeddings), dense and nf4a.

Tolerances: float32 blocks atol 1e-4 (tests/test_torch_block.py's: f32
matmuls and softmax summed in another order); nf4a blocks 2e-2 of the
output's largest magnitude (tests/test_torch_block.py QUANT_REL: one bf16
ulp of a rounded product, carried through the block)."""

import asyncio
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.models.llama.config import LlamaBlockConfig as JaxLlamaConfig
from petals_tpu.models.registry import get_family as jax_get_family
from petals_tpu.ops.paged_attention import PagedKV as JPagedKV
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.registry import get_family
from petals_tpu_torch.ops.paged_attention import PagedKV as TPagedKV
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.utils.convert import block_params_from_numpy
from tests.test_torch_block import carry_quantized
from tests.utils import make_tiny_qwen2

pytestmark = pytest.mark.timeout(300)

ATOL = 1e-4
QUANT_REL = 2e-2
N_LAYERS = 2


@pytest.fixture(scope="module")
def qwen2_path(tmp_path_factory):
    return make_tiny_qwen2(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fuse_qkv(params: dict) -> dict:
    """Dense q/k/v weights and biases concatenated into wqkv / bqkv, as the
    quantized load fuses them (utils/convert_block.py _FUSE_GROUPS)."""
    out = dict(params)
    out["wqkv"] = np.concatenate([np.asarray(out.pop(k)) for k in ("wq", "wk", "wv")], axis=1)
    out["bqkv"] = np.concatenate([np.asarray(out.pop(k)) for k in ("bq", "bk", "bv")], axis=0)
    return out


def _both_blocks(jparams, jcfg, cfg, layout, weights):
    """(JAX params, port params) for one block in the layout and weight kind
    asked for; the port's are carried across from the JAX ones."""
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    if weights == "nf4a":
        jq = jax_convert({k: jnp.asarray(v) for k, v in jparams.items()}, "qwen2", "nf4a", fuse=layout == "fused")
        assert ("wqkv" in jq and "bqkv" in jq) == (layout == "fused")
        return jq, block_params_from_numpy(carry_quantized(jq), "cpu", torch.float32)
    if layout == "fused":
        jparams = _fuse_qkv(jparams)
    return {k: jnp.asarray(v) for k, v in jparams.items()}, block_params_from_numpy(jparams, "cpu", torch.float32)


def _check(got, want, weights, what):
    want = np.asarray(want)
    if weights == "nf4a":
        err = np.abs(got - want).max()
        assert err <= QUANT_REL * np.abs(want).max(), (what, err, np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


def _dense_and_paged_parity(jfamily, jcfg, jp, family, cfg, tp, weights, seed):
    """A 9-token prefill and a decode step over a dense cache, then per-lane
    decode over permuted page tables (lane 1 idle at the sentinel)."""
    rng = np.random.default_rng(seed)
    hkv, d, hsz = cfg.num_key_value_heads, cfg.head_dim, cfg.hidden_size
    x = (rng.standard_normal((1, 9, hsz)) * 0.5).astype(np.float32)
    step = (rng.standard_normal((1, 1, hsz)) * 0.5).astype(np.float32)
    jkv = (jnp.zeros((1, 16, hkv, d)), jnp.zeros((1, 16, hkv, d)))
    tkv = (torch.zeros(1, 16, hkv, d), torch.zeros(1, 16, hkv, d))
    jout, jkv = jfamily.block_apply(jp, jnp.asarray(x), jkv, 0, jcfg)
    tout, tkv = family.block_apply(tp, t(x), tkv, 0, cfg)
    _check(tout.numpy(), jout, weights, "prefill")
    jout, jkv = jfamily.block_apply(jp, jnp.asarray(step), jkv, 9, jcfg)
    tout, tkv = family.block_apply(tp, t(step), tkv, 9, cfg)
    _check(tout.numpy(), jout, weights, "decode")
    for got, want in zip(tkv, jkv):
        _check(got.numpy(), want, weights, "kv")

    n_lanes, max_pages, ps, n_pages = 3, 4, 4, 14
    kp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[: n_lanes * max_pages].astype(np.int32).reshape(n_lanes, max_pages)
    positions = np.array([5, max_pages * ps, 13], np.int32)
    xl = (rng.standard_normal((n_lanes, 1, hsz)) * 0.5).astype(np.float32)
    jout, (jk, _) = jfamily.block_apply(
        jp, jnp.asarray(xl),
        (JPagedKV(jnp.asarray(kp), jnp.asarray(tables)), JPagedKV(jnp.asarray(vp), jnp.asarray(tables))),
        jnp.asarray(positions), jcfg,
    )
    tk, tv = t(kp.copy()), t(vp.copy())
    tout, _ = family.block_apply(tp, t(xl), (TPagedKV(tk, t(tables)), TPagedKV(tv, t(tables))), t(positions), cfg)
    for lane in (0, 2):
        _check(tout.numpy()[lane], np.asarray(jout)[lane], weights, f"paged lane {lane}")
    _check(tk.numpy(), jk.pool, weights, "paged k pool")


@pytest.mark.parametrize("weights", ["float32", "nf4a"])
@pytest.mark.parametrize("layout", ["separate", "fused"])
def test_qwen2_block_matches_petals_tpu(qwen2_path, layout, weights):
    jfamily, jcfg = jax_block_config(qwen2_path)
    family, cfg = get_block_config(qwen2_path)
    assert (cfg.qkv_bias, cfg.attention_bias) == (jcfg.qkv_bias, jcfg.attention_bias) == (True, False)
    jparams = jax_load_block(qwen2_path, 1, dtype=jnp.float32, family=jfamily, cfg=jcfg)
    own = load_block_params(qwen2_path, 1, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    assert sorted(own) == sorted(jparams) and {"bq", "bk", "bv"} <= set(own) and "bo" not in own
    for name in own:
        np.testing.assert_array_equal(own[name].numpy(), np.asarray(jparams[name]), err_msg=name)
    jp, tp = _both_blocks(jparams, jcfg, cfg, layout, weights)
    _dense_and_paged_parity(jfamily, jcfg, jp, family, cfg, tp, weights, seed=4)
    # the biases move the output by more than the tolerance
    unbiased = {k: (torch.zeros_like(v) if k in ("bq", "bk", "bv", "bqkv") else v) for k, v in tp.items()}
    x = t(np.random.default_rng(9).standard_normal((1, 5, cfg.hidden_size)).astype(np.float32))
    kv = lambda: (torch.zeros(1, 8, cfg.num_key_value_heads, cfg.head_dim),) * 2  # noqa: E731
    with_bias, _ = family.block_apply(tp, x, tuple(z.clone() for z in kv()), 0, cfg)
    without, _ = family.block_apply(unbiased, x, tuple(z.clone() for z in kv()), 0, cfg)
    assert (with_bias - without).abs().max().item() > 1e-2


@pytest.mark.parametrize("weights", ["float32", "nf4a"])
def test_qwen2_block_at_a_gqa_group_of_seven(weights):
    """7 query heads over 1 kv head (Qwen2.5-7B's group), head_dim 64."""
    fields = dict(
        hidden_size=448, num_attention_heads=7, num_key_value_heads=1, head_dim=64, intermediate_size=256,
        num_hidden_layers=1, rms_norm_eps=1e-6, rope_theta=1e6, attention_bias=False, qkv_bias=True,
    )
    jcfg, cfg = JaxLlamaConfig(**fields), LlamaBlockConfig(**fields)
    jfamily, family = jax_get_family("qwen2"), get_family("qwen2")
    h, q, kv, m = 448, 7 * 64, 64, 256
    rng = np.random.default_rng(17)
    shapes = {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h), "wg": (h, m), "wu": (h, m), "wd": (m, h)}
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in shapes.items()}
    params.update({k: (rng.standard_normal(n) * 0.1).astype(np.float32) for k, n in (("bq", q), ("bk", kv), ("bv", kv))})
    params.update(ln1=np.ones(h, np.float32), ln2=np.ones(h, np.float32))
    jp, tp = _both_blocks(params, jcfg, cfg, "fused" if weights == "nf4a" else "separate", weights)
    _dense_and_paged_parity(jfamily, jcfg, jp, family, cfg, tp, weights, seed=5)


def test_qwen2_sliding_window_is_refused(qwen2_path, tmp_path):
    path = str(tmp_path / "windowed")
    shutil.copytree(qwen2_path, path)
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    config["use_sliding_window"] = True
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    with pytest.raises(NotImplementedError, match="use_sliding_window"):
        get_block_config(path)
    with pytest.raises(NotImplementedError, match="use_sliding_window"):
        jax_block_config(path)  # petals_tpu refuses it the same way
    family, cfg = get_block_config(qwen2_path)
    assert family.name == "qwen2" and cfg.tie_word_embeddings and cfg.sliding_window is None
    assert dataclasses.replace(cfg, qkv_bias=False) != cfg


def _rms(x, w, eps):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * w


async def _greedy(client, uids, head, prompt, n_new):
    """Greedy loop over raw ptu.inference steps, the embeddings, final norm
    and (tied) head applied here from the checkpoint's tensors."""
    from petals_tpu.rpc.serialization import deserialize_array, serialize_array

    embed, norm_w, eps = head
    stream = await client.open_stream("ptu.inference")
    await stream.send({"uids": uids, "max_length": 64, "batch_size": 1})
    await stream.recv(timeout=60)
    tokens = list(prompt)
    hidden = embed[np.asarray(tokens)][None]
    for _ in range(n_new):
        await stream.send({"tensors": {"hidden": serialize_array(hidden.astype(np.float32))}})
        out = deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"])
        logits = _rms(out[0, -1].astype(np.float32), norm_w, eps) @ embed.T
        tokens.append(int(np.argmax(logits)))
        hidden = embed[tokens[-1:]][None]
    await stream.end()
    return tokens[len(prompt):]


@pytest.mark.parametrize("quant_type", ["none", "nf4a"])
def test_qwen2_greedy_tokens_match_petals_tpu_server(qwen2_path, quant_type):
    from safetensors.numpy import load_file

    from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu.rpc import RpcClient
    from petals_tpu.server.server import Server as JaxServer
    from petals_tpu_torch.server.server import Server, default_dht_prefix

    weights = load_file(os.path.join(qwen2_path, "model.safetensors"))
    assert "lm_head.weight" not in weights  # tied
    _, jcfg = jax_block_config(qwen2_path)
    head = (weights["model.embed_tokens.weight"], weights["model.norm.weight"], jcfg.rms_norm_eps)
    prompt = [3, 17, 42, 5, 99]
    uids = CHAIN_DELIMITER.join(make_uid(default_dht_prefix(qwen2_path), i) for i in range(N_LAYERS))

    async def main():
        server = Server(
            qwen2_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
            batch_lanes=2, batch_max_length=128, page_size=16, prefill_token_budget=16, quant_type=quant_type,
            throughput=1.0,
        )
        await server.start()
        client = await RpcClient.connect(server.host, server.rpc_server.port)
        try:
            port_tokens = await _greedy(client, uids, head, prompt, 8)
        finally:
            await client.close()
            await server.shutdown()
        jserver = JaxServer(
            qwen2_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
            batching=True, batch_lanes=2, batch_max_length=128, page_size=16,
            prefix_cache_bytes=0, prefix_device_bytes=0, server_side_generation=False,
            quant_type=quant_type, quant_weight_cache=False,
        )
        await jserver.start()
        jclient = await RpcClient.connect(jserver.rpc_server.host, jserver.rpc_server.port)
        try:
            jax_tokens = await _greedy(jclient, uids, head, prompt, 8)
        finally:
            await jclient.close()
            await jserver.shutdown()
        return port_tokens, jax_tokens, server

    port_tokens, jax_tokens, server = asyncio.run(main())
    if quant_type == "nf4a":
        assert "bqkv" in server.backend.block_params[0] and "wqkv" in server.backend.block_params[0]
    assert len(port_tokens) == 8
    assert port_tokens == jax_tokens
