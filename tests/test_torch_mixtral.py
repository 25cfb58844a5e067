"""The Mixtral (MoE) family in the port against petals_tpu's, on the CPU, on
``make_tiny_mixtral`` (4 query heads over 2 kv heads, 4 experts, top-2).

- Each package's loader gives the same config and weights (each
  projection's experts stacked [E, in, out]).
- The block equals petals_tpu's in the five cache modes of
  tests/test_torch_bloom.py ``block_parity``: its 12-row chunks take the
  sparse (grouped) dispatch, its decode steps the dense one.
- Routing equals ``jax.lax.top_k``'s, a forced tie included (the lower
  expert first).
- ``moe_apply`` equals the JAX package's in each dispatch, dense and
  sparse, and with nf4a and int8 experts (which take the dense dispatch at
  every length, one expert at a time).
- The plain grouped product equals ``jax.lax.ragged_dot``, with an empty
  group and a group that takes every row; a wrong split is refused.
- Expert stacks cross ``block_params_from_numpy`` and ``stacked_from_numpy``
  dense and quantized, and the backend's per-block view slices them.
- The quantization tables quantize the experts per expert with the base
  kind (nf4a+o's experts are plain nf4a), as the JAX package's do. The
  quantized cases run on a tiny checkpoint written here in HF's layout
  whose expert widths the 4-bit kinds take.
- A port server's greedy tokens equal a petals_tpu server's at
  ``--quant_type none`` and ``nf4a``.

Tolerances: tests/test_torch_bloom.py's; the MoE and the grouped product in
float32 atol 1e-5 (the same float32 products in another order); quantized
experts within 2e-2 of the output's largest magnitude (tests/test_torch_block.py
QUANT_REL: one bf16 rounding of a product, carried through the MoE)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.models.mixtral import block as jblock
from petals_tpu.utils.convert_block import convert_block_params as jax_convert
from petals_tpu_torch.models.mixtral import block as tblock
from petals_tpu_torch.ops.grouped_matmul import grouped_matmul, grouped_matmul_reference
from petals_tpu_torch.ops.quant import QuantizedLinear
from petals_tpu_torch.server.backend import _block_view
from petals_tpu_torch.utils.convert import block_params_from_numpy, stacked_from_numpy
from tests.test_torch_block import carry_quantized
from tests.test_torch_bloom import (
    MODES,
    block_parity,
    client_parity,
    greedy_streams,
    loaders_agree,
    quant_tables_parity,
    sizing_parity,
    t,
)
from tests.utils import make_tiny_mixtral

pytestmark = pytest.mark.timeout(300)

MOE_ATOL = 1e-5
QUANT_REL = 2e-2


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    path = make_tiny_mixtral(str(tmp_path_factory.mktemp("models")), n_layers=2)
    return (path, *loaders_agree(path))


@pytest.fixture(scope="module")
def mixtral_q(tmp_path_factory):
    """A tiny Mixtral checkpoint in HF's layout whose widths the 4-bit kinds
    take (an in-width a multiple of 64: make_tiny_mixtral's 96-wide experts
    are refused by both packages), random weights from a seed."""
    import json

    from safetensors.numpy import save_file

    path = str(tmp_path_factory.mktemp("models") / "tiny-mixtral-q")
    h, m, hq, hkv, E, vocab, n_layers = 64, 128, 4, 2, 4, 128, 2
    d = h // hq
    rng = np.random.default_rng(71)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.08).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(vocab, h), "lm_head.weight": w(vocab, h),
               "model.norm.weight": np.ones(h, np.float32)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": np.ones(h, np.float32),
            p + "post_attention_layernorm.weight": np.ones(h, np.float32),
            p + "self_attn.q_proj.weight": w(hq * d, h), p + "self_attn.k_proj.weight": w(hkv * d, h),
            p + "self_attn.v_proj.weight": w(hkv * d, h), p + "self_attn.o_proj.weight": w(h, hq * d),
            p + "block_sparse_moe.gate.weight": w(E, h),
        })
        for e in range(E):
            q = f"{p}block_sparse_moe.experts.{e}."
            tensors.update({q + "w1.weight": w(m, h), q + "w2.weight": w(h, m), q + "w3.weight": w(m, h)})
    import os

    os.makedirs(path)
    save_file(tensors, os.path.join(path, "model.safetensors"), metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(model_type="mixtral", architectures=["MixtralForCausalLM"], vocab_size=vocab, hidden_size=h,
                       intermediate_size=m, num_hidden_layers=n_layers, num_attention_heads=hq,
                       num_key_value_heads=hkv, num_local_experts=E, num_experts_per_tok=2, rms_norm_eps=1e-6,
                       sliding_window=None, tie_word_embeddings=False), f)
    return (path, *loaders_agree(path))


def test_mixtral_config_and_stacks(mixtral):
    _, _, jcfg, family, cfg, params = mixtral
    assert family.name == "mixtral" and (cfg.num_local_experts, cfg.num_experts_per_tok) == (4, 2)
    E, h, m = cfg.num_local_experts, cfg.hidden_size, cfg.intermediate_size
    assert params["w1"].shape == params["w3"].shape == (E, h, m) and params["w2"].shape == (E, m, h)
    assert tblock.SPARSE_MIN_SEQ == jblock.SPARSE_MIN_SEQ


@pytest.mark.parametrize("mode", MODES)
def test_mixtral_block_matches_petals_tpu(mixtral, mode):
    _, jfamily, jcfg, family, cfg, params = mixtral
    block_parity(jfamily, jcfg, family, cfg, params, mode, seed=51)


def _x(cfg, shape, seed):
    return (np.random.default_rng(seed).standard_normal((*shape, cfg.hidden_size)) * 0.5).astype(np.float32)


def test_routing_matches_jax_with_a_forced_tie(mixtral):
    """Experts 1 and 2 get the same router column, so every row ties them;
    top-2 must name the lower one first, as jax.lax.top_k does."""
    _, _, _, _, cfg, params = mixtral
    gate = np.abs(params["gate"])
    gate[:, 2] = gate[:, 1]
    gate[:, 0] *= -1.0  # positive rows score experts 0 and 3 below the tie: it decides both picks
    gate[:, 3] *= -1.0
    x = np.abs(_x(cfg, (2, 5), 61))
    probs, idx = tblock.route(t(x), t(gate), cfg.num_experts_per_tok)
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(gate), axis=-1)
    jtop, jidx = jax.lax.top_k(jprobs, cfg.num_experts_per_tok)
    jtop = jtop / jtop.sum(-1, keepdims=True)
    assert (np.asarray(jidx) == [1, 2]).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jtop), atol=1e-7, rtol=0)
    # untied rows of the real router agree too
    x = _x(cfg, (3, 7), 62)
    probs, idx = tblock.route(t(x), t(params["gate"]), cfg.num_experts_per_tok)
    jtop, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(params["gate"]), axis=-1), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jtop / jtop.sum(-1, keepdims=True)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("sparse", [False, True])
def test_moe_matches_jax_in_each_dispatch(mixtral, sparse):
    _, _, jcfg, _, cfg, params = mixtral
    x = _x(cfg, (2, 9), 63)
    want = jblock.moe_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jcfg, sparse=sparse)
    got = tblock.moe_apply(block_params_from_numpy(params, "cpu", torch.float32), t(x), cfg, sparse=sparse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL, rtol=0)
    # the two dispatches agree with each other to float32 summation order
    other = tblock.moe_apply(block_params_from_numpy(params, "cpu", torch.float32), t(x), cfg, sparse=not sparse)
    np.testing.assert_allclose(got.numpy(), other.numpy(), atol=MOE_ATOL, rtol=0)


@pytest.mark.parametrize("sizes", [(0, 5, 0, 3), (8, 0, 0, 0), (2, 2, 2, 2)])
def test_plain_grouped_matmul_matches_ragged_dot(sizes):
    rng = np.random.default_rng(sum(sizes) + sizes[0])
    n, k, m = sum(sizes), 24, 40
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, m)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    got = grouped_matmul(t(x), t(w), t(gs))  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL, rtol=0)
    bf = grouped_matmul_reference(t(x).to(torch.bfloat16), t(w).to(torch.bfloat16), t(gs))
    assert bf.dtype == torch.bfloat16 and bf.shape == (n, m)
    with pytest.raises(ValueError, match="do not split"):
        grouped_matmul(t(x), t(w), t(gs + 1))


@pytest.mark.parametrize("kind", ["nf4a", "int8"])
def test_quantized_moe_matches_jax(mixtral_q, kind):
    """Quantized experts take the dense dispatch at every length (even asked
    for the sparse one), one expert at a time, as the JAX package's do."""
    _, _, jcfg, _, cfg, params = mixtral_q
    jq = jax_convert({k: jnp.asarray(v) for k, v in params.items()}, "mixtral", kind)
    tp = block_params_from_numpy(carry_quantized(jq), "cpu", torch.float32)
    assert isinstance(tp["w1"], QuantizedLinear) and tp["w1"].data.shape[0] == cfg.num_local_experts
    x = _x(cfg, (1, 10), 64)
    want = np.asarray(jblock.moe_apply(jq, jnp.asarray(x), jcfg, sparse=True))
    got = tblock.moe_apply(tp, t(x), cfg, sparse=True).numpy()
    err = np.abs(got - want).max()
    assert err <= QUANT_REL * np.abs(want).max(), (kind, err, np.abs(want).max())


def test_expert_stacks_cross_and_slice(mixtral_q):
    """Dense and quantized [E, in, out] stacks cross from numpy, stack over
    blocks and come back per block through the backend's view."""
    _, _, _, _, cfg, params = mixtral_q
    jq = jax_convert({k: jnp.asarray(v) for k, v in params.items()}, "mixtral", "nf4a")
    for block in (params, carry_quantized(jq)):
        one = block_params_from_numpy(block, "cpu", torch.float32)
        span = stacked_from_numpy([block, block], "cpu", torch.float32)
        for name, leaf in one.items():
            view = _block_view(span[name], 1)
            if isinstance(leaf, QuantizedLinear):
                assert view.data.shape == leaf.data.shape
                assert (leaf.data.dim() == 3) == (name in ("w1", "w2", "w3")), name
                assert torch.equal(view.data, leaf.data) and torch.equal(view.scales, leaf.scales)
            else:
                assert torch.equal(view, leaf), name


def test_mixtral_quantization_tables_match_jax(mixtral_q):
    quant_tables_parity(mixtral_q[-1], "mixtral", kinds=("int8", "nf4a", "nf4a+o"))


def test_mixtral_client_pieces_match_jax(mixtral):
    client_parity(mixtral[0], [3, 17, 42, 5])


def test_mixtral_sizing_reads_the_reference_fields(mixtral, monkeypatch, tmp_path):
    sizing_parity(mixtral[0], monkeypatch, tmp_path)


@pytest.mark.parametrize("quant_type", ["none", "nf4a"])
def test_mixtral_greedy_tokens_match_petals_tpu_server(mixtral, mixtral_q, quant_type):
    path = mixtral[0] if quant_type == "none" else mixtral_q[0]
    port, jax_tokens = greedy_streams(path, 2, quant_type, [3, 17, 42, 5, 99, 7, 8, 9, 10, 11])
    assert port == jax_tokens
