"""The port's training backward (CPU) against petals_tpu's.

- The quantized product's gradient: ``ops/quant.py QuantMatmulFn`` against
  ``jax.grad`` in x of petals_tpu's ``_make_quant_mm`` (and of its
  ``quant_matmul`` for the ``+o`` kinds), on the same encoded bytes, for
  every kind; within one bf16 ulp of the largest entry (both round the
  gradient to bf16 once, from float32 sums taken in another order).
- ``TransformerBackend.backward`` against petals_tpu's on tiny-llama's 4
  blocks: the whole span and a sub-span, with and without deep prompts, with
  float32 and nf4a weights, with and without a LoRA adapter. Float32: atol
  1e-4, petals_tpu's own bound (tests/test_training.py). nf4a: 2e-2 of the
  largest entry, the bound the quantized forward parity keeps
  (tests/test_torch_backend.py QUANT_REL): every quantized product rounds to
  bf16 on both sides, and one ulp of difference in a block's activations
  carries through the later blocks and back.

The wire and the client's repair path are in tests/test_torch_training.py.

Inputs come from numpy seeds; every wait is bounded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petals_tpu.ops.quant as jq
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch.ops import quant as tq
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.test_torch_quant import port_leaf
from tests.utils import make_tiny_llama

N_LAYERS = 4
ATOL = 1e-4  # petals_tpu's float32 backward bound (tests/test_training.py)
QUANT_REL = 2e-2

pytestmark = pytest.mark.timeout(600)


def _bf16_ulp(x: np.ndarray) -> float:
    mag = max(float(np.abs(x).max()), float(np.finfo(np.float32).tiny))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------- the quantized product's gradient


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("kind", ["int8", "nf4", "nf4a", "int4", "nf4a+o", "int4+o"])
def test_quant_matmul_grad_matches_jax_custom_vjp(kind, m):
    rng = np.random.default_rng(m + len(kind))
    w = (rng.standard_normal((192, 96)) * 0.05).astype(np.float32)
    jleaf = jq.quantize(jnp.asarray(w), kind)
    tleaf = port_leaf(jleaf)
    x = (rng.standard_normal((m, 192)) * 0.5).astype(np.float32)
    g = (rng.standard_normal((m, 96)) * 0.5).astype(np.float32)

    def f(xj):
        return jnp.sum(jq.quant_matmul(xj, jleaf) * g)

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tq.quant_matmul(xt, tleaf)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == x.shape
    # the forward is the plain version's bits, grad or not
    with torch.no_grad():
        np.testing.assert_array_equal(out.detach().numpy(), tq.quant_matmul(torch.from_numpy(x), tleaf).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_bf16_ulp(want))


def test_quant_matmul_takes_the_function_only_under_grad():
    rng = np.random.default_rng(3)
    leaf = tq.quantize(torch.from_numpy((rng.standard_normal((128, 64)) * 0.05).astype(np.float32)), "nf4a")
    x = torch.from_numpy(rng.standard_normal((3, 128)).astype(np.float32)).requires_grad_(True)
    with torch.no_grad():
        assert tq.quant_matmul(x, leaf).grad_fn is None
    fn, names = tq.quant_matmul(x, leaf).grad_fn, []
    while fn is not None:
        names.append(type(fn).__name__)
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert any(n.startswith("QuantMatmulFn") for n in names), names
    # the weights get no gradient: the backward gives one to x alone
    assert tq.QuantMatmulFn.backward(type("Ctx", (), {"w": leaf})(), torch.ones(3, 64))[1] is None


# ---------------------------------------------------------------- backend.backward


def make_adapter(root, model_path, *, name="lora-a", seed=0, rank=4, alpha=8.0,
                 targets=("self_attn.q_proj", "self_attn.v_proj", "mlp.down_proj"), blocks=None):
    """A PEFT checkpoint written with the port's safetensors writer:
    adapter_config.json and lora_A / lora_B of ``targets`` in ``blocks``
    (default: every block), drawn from ``seed``."""
    import json
    import os

    from petals_tpu_torch.server.from_pretrained import load_hf_config
    from petals_tpu_torch.utils.safetensors_io import save_file

    cfg = load_hf_config(model_path)
    hq, hkv = cfg.num_attention_heads, getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    d = cfg.hidden_size // hq
    dims = {
        "self_attn.q_proj": (cfg.hidden_size, hq * d), "self_attn.k_proj": (cfg.hidden_size, hkv * d),
        "self_attn.v_proj": (cfg.hidden_size, hkv * d), "self_attn.o_proj": (hq * d, cfg.hidden_size),
        "mlp.gate_proj": (cfg.hidden_size, cfg.intermediate_size),
        "mlp.up_proj": (cfg.hidden_size, cfg.intermediate_size),
        "mlp.down_proj": (cfg.intermediate_size, cfg.hidden_size),
    }
    rng = np.random.RandomState(seed)
    tensors = {}
    for i in (range(cfg.num_hidden_layers) if blocks is None else blocks):
        for proj in targets:
            n_in, n_out = dims[proj]
            base = f"base_model.model.model.layers.{i}.{proj}"
            tensors[f"{base}.lora_A.weight"] = torch.from_numpy((rng.standard_normal((rank, n_in)) * 0.1).astype(np.float32))
            tensors[f"{base}.lora_B.weight"] = torch.from_numpy((rng.standard_normal((n_out, rank)) * 0.1).astype(np.float32))
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha, "peft_type": "LORA"}, f)
    return path


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def adapter_path(model_path, tmp_path_factory):
    return make_adapter(str(tmp_path_factory.mktemp("adapters")), model_path)


def backend_pair(model_path, adapter_path, quant, lo, hi):
    """A petals_tpu backend and a port backend over blocks [lo, hi), float32
    compute, the same weights (``quant``: "none" or a kind, the same bytes)
    and the adapter loaded on both."""
    from petals_tpu.utils.convert_block import convert_block_params as jax_convert
    from petals_tpu.utils.peft import load_adapter as jax_load_adapter
    from petals_tpu.utils.peft import stack_adapter as jax_stack_adapter
    from petals_tpu_torch.utils.peft import load_adapter, stack_adapter

    jfamily, jcfg = jax_block_config(model_path)
    per_block = [jax_load_block(model_path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(lo, hi)]
    if quant != "none":  # unfused, as a server with adapters loads
        per_block = [jax_convert(p, jfamily.name, quant, fuse=False) for p in per_block]
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block)
    jb = JaxBackend(jfamily, jcfg, jstacked, first_block=lo, n_blocks=hi - lo,
                    memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False)
    ja = jax_load_adapter(adapter_path, jfamily.name, block_range=range(lo, hi))
    jb.adapters[ja.name] = (jax_stack_adapter(ja, lo, hi - lo, jnp.float32), ja.scaling)
    family, cfg = get_block_config(model_path)
    blocks = [{k: port_leaf(v) for k, v in p.items()} for p in per_block]
    tb = TransformerBackend(family, cfg, stacked_from_numpy(blocks, "cpu", torch.float32), first_block=lo,
                            n_blocks=hi - lo, device="cpu", compute_dtype=torch.float32, quant_type=quant)
    ta = load_adapter(adapter_path, family.name, block_range=range(lo, hi))
    tb.adapters[ta.name] = (stack_adapter(ta, lo, hi - lo, torch.float32, "cpu"), ta.scaling)
    return jb, tb, cfg


CASES = [  # (weights, span, deep prompts, adapter)
    ("none", (0, N_LAYERS), False, None),
    ("none", (0, N_LAYERS), True, None),
    ("none", (1, 3), False, None),
    ("none", (1, 3), True, None),
    ("none", (0, N_LAYERS), True, "lora-a"),
    ("none", (1, 3), False, "lora-a"),
    ("nf4a", (0, N_LAYERS), False, None),
    ("nf4a", (0, N_LAYERS), True, None),
    ("nf4a", (0, N_LAYERS), True, "lora-a"),
]


@pytest.mark.parametrize("quant,span,with_prompts,adapter", CASES,
                         ids=[f"{q}-{s[0]}:{s[1]}-{'prompts' if p else 'plain'}-{a or 'base'}" for q, s, p, a in CASES])
def test_backend_backward_matches_petals_tpu(model_path, adapter_path, quant, span, with_prompts, adapter):
    lo, hi = span
    jb, tb, cfg = backend_pair(model_path, adapter_path, quant, lo, hi)
    rng = np.random.RandomState(hi * 7 + lo + int(with_prompts))
    hidden = (rng.standard_normal((2, 9, cfg.hidden_size)) * 0.3).astype(np.float32)
    grad_out = (rng.standard_normal((2, 9, cfg.hidden_size)) * 0.3).astype(np.float32)
    prompts = (rng.standard_normal((hi - lo, 2, 3, cfg.hidden_size)) * 0.3).astype(np.float32) if with_prompts else None
    want_h, want_p = jb.backward(hidden, grad_out, prompts=prompts, active_adapter=adapter)
    got_h, got_p = tb.backward(hidden, grad_out, prompts=prompts, active_adapter=adapter)
    assert got_h.dtype == torch.float32 and tuple(got_h.shape) == hidden.shape
    assert (got_p is None) == (prompts is None)

    def close(got, want, what):
        want = np.asarray(want)
        if quant == "none":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=what)
        else:
            err = np.abs(got.numpy() - want).max()
            assert err <= QUANT_REL * np.abs(want).max(), (what, err, np.abs(want).max())

    close(got_h, want_h, "grad_hidden")
    if prompts is not None:
        assert tuple(got_p.shape) == prompts.shape
        close(got_p, want_p, "grad_prompts")
    if adapter is not None:  # the adapter moves the gradient
        base_h, _ = tb.backward(hidden, grad_out, prompts=prompts)
        assert float((base_h - got_h).abs().max()) > 1e-3


def test_backward_refuses_an_unknown_adapter_and_a_mismatched_grad(model_path, adapter_path):
    _, tb, cfg = backend_pair(model_path, adapter_path, "none", 0, 2)
    h = np.zeros((1, 3, cfg.hidden_size), np.float32)
    with pytest.raises(KeyError, match="Adapter 'nope' is not loaded on this server"):
        tb.backward(h, h, active_adapter="nope")
    with pytest.raises(ValueError, match="does not match"):
        tb.backward(h, np.zeros((1, 4, cfg.hidden_size), np.float32))
