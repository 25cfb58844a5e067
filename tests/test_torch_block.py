"""The port's ``block_apply`` (llama and mistral families) against the JAX
package's, on the same weights carried across as numpy
(petals_tpu_torch.utils.convert), over a dense cache and over a paged pool,
on the CPU in f32. The port's own checkpoint reader must give the same
weights as the JAX loader.

Tolerance: atol 1e-4 (f32 matmuls and softmax summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops.paged_attention import PagedKV as JPagedKV
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu_torch.ops.paged_attention import PagedKV as TPagedKV
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.utils.convert import block_params_from_numpy
from tests.utils import make_tiny_llama, make_tiny_mistral

ATOL = 1e-4


@pytest.fixture(scope="module", params=["llama", "mistral"])
def model(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("models"))
    path = make_tiny_llama(root, n_layers=2) if request.param == "llama" else make_tiny_mistral(root, n_layers=2, window=6)
    jfamily, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    jparams = jax_load_block(path, 1, dtype=jnp.float32, family=jfamily, cfg=jcfg)
    params = block_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu", torch.float32)
    return path, (jfamily, jcfg, jparams), (family, cfg, params)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_config_and_loader_agree(model):
    path, (_, jcfg, jparams), (family, cfg, params) = model
    assert cfg.sliding_window == jcfg.sliding_window
    assert (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim) == (
        jcfg.hidden_size, jcfg.num_attention_heads, jcfg.num_key_value_heads, jcfg.head_dim,
    )
    own = load_block_params(path, 1, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    assert sorted(own) == sorted(params)
    for name in own:
        np.testing.assert_array_equal(own[name].numpy(), np.asarray(jparams[name]), err_msg=name)


def test_block_dense_prefill_then_decode(model):
    _, (jfamily, jcfg, jparams), (family, cfg, params) = model
    rng = np.random.default_rng(0)
    batch, seq, max_len = 2, 9, 16
    hkv, d = cfg.num_key_value_heads, cfg.head_dim
    x = (rng.standard_normal((batch, seq, cfg.hidden_size)) * 0.5).astype(np.float32)
    step = (rng.standard_normal((batch, 1, cfg.hidden_size)) * 0.5).astype(np.float32)
    jkv = (jnp.zeros((batch, max_len, hkv, d)), jnp.zeros((batch, max_len, hkv, d)))
    tkv = (torch.zeros(batch, max_len, hkv, d), torch.zeros(batch, max_len, hkv, d))
    jout, jkv = jfamily.block_apply(jparams, jnp.asarray(x), jkv, 0, jcfg)
    tout, tkv = family.block_apply(params, t(x), tkv, 0, cfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    jout, jkv = jfamily.block_apply(jparams, jnp.asarray(step), jkv, seq, jcfg)
    tout, tkv = family.block_apply(params, t(step), tkv, seq, cfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    for got, want in zip(tkv, jkv):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_block_paged_decode_and_chunk(model):
    """Per-lane decode over permuted tables (one lane idle at the sentinel)
    and a padded prefill chunk (n_valid < rows) at a non-zero position."""
    _, (jfamily, jcfg, jparams), (family, cfg, params) = model
    rng = np.random.default_rng(1)
    n_lanes, max_pages, ps = 3, 4, 4
    n_pages = 14
    hkv, d = cfg.num_key_value_heads, cfg.head_dim
    kp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[: n_lanes * max_pages].astype(np.int32).reshape(n_lanes, max_pages)
    positions = np.array([5, max_pages * ps, 13], np.int32)
    x = (rng.standard_normal((n_lanes, 1, cfg.hidden_size)) * 0.5).astype(np.float32)

    jout, (jk, jv) = jfamily.block_apply(
        jparams, jnp.asarray(x),
        (JPagedKV(jnp.asarray(kp), jnp.asarray(tables)), JPagedKV(jnp.asarray(vp), jnp.asarray(tables))),
        jnp.asarray(positions), jcfg,
    )
    tk, tv = t(kp.copy()), t(vp.copy())
    tout, _ = family.block_apply(
        params, t(x), (TPagedKV(tk, t(tables)), TPagedKV(tv, t(tables))), t(positions), cfg
    )
    for lane in (0, 2):
        np.testing.assert_allclose(tout.numpy()[lane], np.asarray(jout)[lane], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk.pool), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.pool), atol=ATOL, rtol=0)

    # a 6-row chunk at position 3 of lane 1, 4 rows real
    row = tables[1:2]
    chunk = (rng.standard_normal((1, 6, cfg.hidden_size)) * 0.5).astype(np.float32)
    jout, (jk, jv) = jfamily.block_apply(
        jparams, jnp.asarray(chunk),
        (JPagedKV(jnp.asarray(kp), jnp.asarray(row)), JPagedKV(jnp.asarray(vp), jnp.asarray(row))),
        3, jcfg, n_valid=4,
    )
    tk, tv = t(kp.copy()), t(vp.copy())
    tout, _ = family.block_apply(
        params, t(chunk), (TPagedKV(tk, t(row)), TPagedKV(tv, t(row))), 3, cfg, n_valid=4
    )
    np.testing.assert_allclose(tout.numpy()[:, :4], np.asarray(jout)[:, :4], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk.pool), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.pool), atol=ATOL, rtol=0)
