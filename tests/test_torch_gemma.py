"""The Gemma (v1) family in the port against petals_tpu's, on the CPU, on
``make_tiny_gemma`` (the llama block with (1 + w)-folded norms, the tanh
GeLU, sqrt(hidden)-scaled embeddings and a tied head).

- Each package's own loader gives the same config (HF GemmaConfig's tied
  head where config.json omits it) and the same folded weights.
- The block equals petals_tpu's ``block_apply`` in the five cache modes of
  tests/test_torch_bloom.py ``block_parity``.
- Loaded in bf16, the folded norms stay float32 in the block and in the
  client (``cast_exempt``), the other weights bf16: the twin of
  tests/test_new_families.py ``test_gemma_norm_fold_survives_bf16_loading``.
- The client pieces (the scaled embedding, the folded final norm, the tied
  float32 head) and the quantization tables equal the JAX package's.
- A port server's greedy tokens equal a petals_tpu server's, and a chain of
  a port server into a petals_tpu server gives the all-port stream.
- The exact GeLU that gemma-7b's config.json names (``hidden_act: gelu``)
  maps as petals_tpu maps it.

Tolerances: tests/test_torch_bloom.py's (float32 atol 1e-4; bf16 2e-2 of
the output's largest magnitude)."""

import types

import pytest
import torch

from petals_tpu.models.llama.config import LlamaBlockConfig as JaxLlamaConfig
from petals_tpu_torch.models.registry import get_family
from tests.test_torch_bloom import (
    MODES,
    block_parity,
    client_parity,
    greedy_streams,
    loaders_agree,
    quant_tables_parity,
)
from tests.utils import make_tiny_gemma

pytestmark = pytest.mark.timeout(300)


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    path = make_tiny_gemma(str(tmp_path_factory.mktemp("models")), n_layers=2)
    return (path, *loaders_agree(path))


def test_gemma_config_follows_petals_tpu(gemma):
    _, _, jcfg, family, cfg, _ = gemma
    assert family.name == "gemma" and cfg.tie_word_embeddings and cfg.hidden_act == "gelu_tanh"
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    # gemma-7b's config.json names the exact GeLU: both packages read it so
    fields = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, head_dim=16, intermediate_size=128,
                  num_hidden_layers=2, rms_norm_eps=1e-6, vocab_size=128, hidden_act="gelu", model_type="gemma")
    port = family.config_from_hf(types.SimpleNamespace(**fields))
    assert port.hidden_act == JaxLlamaConfig.from_hf_config(types.SimpleNamespace(**fields)).hidden_act == "gelu"


@pytest.mark.parametrize("mode", MODES)
def test_gemma_block_matches_petals_tpu(gemma, mode):
    _, jfamily, jcfg, family, cfg, params = gemma
    block_parity(jfamily, jcfg, family, cfg, params, mode, seed=51)


def test_gemma_norm_fold_survives_bf16_loading(gemma):
    from petals_tpu_torch.client.from_pretrained import load_client_params
    from petals_tpu_torch.server.from_pretrained import load_block_params

    path = gemma[0]
    params = load_block_params(path, 0, dtype=torch.bfloat16, device="cpu")
    assert params["ln1"].dtype == params["ln2"].dtype == torch.float32
    assert params["wq"].dtype == torch.bfloat16
    raw = load_block_params(path, 0, dtype=torch.float32, device="cpu")
    assert torch.equal(params["ln1"], raw["ln1"])  # the exact float32 fold, not a bf16 round of it
    client = load_client_params(path, dtype=torch.bfloat16, device="cpu")
    assert client["norm"].dtype == torch.float32 and client["embed"].dtype == torch.bfloat16
    # the carry of petals_tpu's loaded block keeps the same rule
    from petals_tpu_torch.utils.convert import block_params_from_numpy

    carried = block_params_from_numpy(gemma[-1], "cpu", torch.bfloat16, gemma[3])  # block 1
    assert carried["ln1"].dtype == torch.float32 and carried["wq"].dtype == torch.bfloat16
    assert torch.equal(carried["ln1"], load_block_params(path, 1, dtype=torch.float32, device="cpu")["ln1"])


def test_gemma_client_pieces_match_jax(gemma):
    client_parity(gemma[0], [3, 17, 42, 5])


def test_gemma_quantization_tables_match_jax(gemma):
    quant_tables_parity(gemma[-1], "gemma")


def test_gemma_greedy_tokens_match_petals_tpu_server(gemma):
    port, jax_tokens = greedy_streams(gemma[0], 2, "none", [3, 17, 42, 5, 99])
    assert port == jax_tokens


def test_gemma_mixed_chain_matches_port_server(gemma):
    port, mixed = greedy_streams(gemma[0], 2, "none", [7, 8, 9, 10], chain=True)
    assert port == mixed


def test_gemma_registers_its_cast_exempt_norms():
    family = get_family("gemma")
    assert family.cast_exempt == ("ln1", "ln2", "norm") and family.block_arch == "llama"
