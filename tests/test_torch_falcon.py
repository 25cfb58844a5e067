"""The Falcon family in the port against petals_tpu's, on the CPU: its three
block layouts as ``make_tiny_falcon`` builds them ("new": the 40B/180B
architecture, GQA with dual LayerNorms; "7b": multi-query, parallel
attention; "rw": MHA with ALiBi, serial, with biases), and a Falcon-7B-
style block at a GQA group above 16.

- Each package's own loader gives the same config (the arch rules for kv
  heads, LayerNorms and the MLP width) and the same weights (each layout's
  fused QKV split at load).
- Each layout's block equals petals_tpu's in the five cache modes of
  tests/test_torch_bloom.py ``block_parity``; so does a block of 20 query
  heads over one kv head (group 20, past the 16 query heads a GPU decode
  block took before the wide-group arm).
- The client pieces, the quantization tables, the chunk sizing and the
  throughput key follow the JAX package's.
- A port server's greedy tokens equal a petals_tpu server's at
  ``--quant_type none`` and ``int8`` (the 7b layout: 4 query heads over one
  kv head).

Tolerances: tests/test_torch_bloom.py's."""

import numpy as np
import pytest

from petals_tpu.models.falcon.config import FalconBlockConfig as JaxFalconConfig
from petals_tpu.models.registry import get_family as jax_get_family
from petals_tpu_torch.models.falcon.config import FalconBlockConfig
from petals_tpu_torch.models.registry import get_family
from tests.test_torch_bloom import (
    MODES,
    block_parity,
    client_parity,
    greedy_streams,
    loaders_agree,
    quant_tables_parity,
    sizing_parity,
)
from tests.utils import make_tiny_falcon

pytestmark = pytest.mark.timeout(300)

VARIANTS = ("new", "7b", "rw")


@pytest.fixture(scope="module", params=VARIANTS)
def falcon(request, tmp_path_factory):
    path = make_tiny_falcon(str(tmp_path_factory.mktemp("models")), variant=request.param, n_layers=2)
    return (request.param, path, *loaders_agree(path))


def test_falcon_arch_rules(falcon):
    variant, _, _, jcfg, _, cfg, _ = falcon
    want = {"new": (2, 2, False), "7b": (1, 1, False), "rw": (4, 1, True)}[variant]
    assert (cfg.num_kv_heads, cfg.num_ln_in_parallel_attn, cfg.alibi) == want
    assert cfg.num_key_value_heads == cfg.num_kv_heads and cfg.ffn_hidden_size == 4 * cfg.hidden_size


@pytest.mark.parametrize("mode", MODES)
def test_falcon_block_matches_petals_tpu(falcon, mode):
    _, _, jfamily, jcfg, family, cfg, params = falcon
    block_parity(jfamily, jcfg, family, cfg, params, mode, seed=31)


@pytest.mark.parametrize("mode", MODES)
def test_falcon_block_at_a_wide_group(mode):
    """20 query heads over one kv head (Falcon-7B's multi-query layout; its
    71 heads are a group of 71), head_dim 16, weights drawn with numpy."""
    fields = dict(
        hidden_size=320, num_attention_heads=20, num_kv_heads=1, num_hidden_layers=1, layer_norm_epsilon=1e-5,
        ffn_hidden_size=256, new_decoder_architecture=False, parallel_attn=True, num_ln_in_parallel_attn=1,
        multi_query=True,
    )
    jcfg, cfg = JaxFalconConfig(**fields), FalconBlockConfig(**fields)
    family = get_family("falcon")
    rng = np.random.default_rng(41)
    params = {
        name: (rng.standard_normal(tuple(meta.shape)) * (0.05 if meta.dim() == 2 else 0.1)).astype(np.float32)
        for name, meta in family.block_param_shapes(cfg).items()
    }
    params["ln1_w"] += 1.0
    block_parity(jax_get_family("falcon"), jcfg, family, cfg, params, mode, seed=42)


def test_falcon_client_pieces_match_jax(falcon):
    client_parity(falcon[1], [3, 17, 42, 5])


def test_falcon_quantization_tables_match_jax(falcon):
    quant_tables_parity(falcon[-1], "falcon")


def test_falcon_sizing_reads_the_reference_fields(falcon, monkeypatch, tmp_path):
    sizing_parity(falcon[1], monkeypatch, tmp_path)


@pytest.mark.parametrize("falcon", ["rw"], indirect=True)
def test_falcon_rw_slopes_are_prescaled(falcon):
    """falcon-rw scales (scores + bias) by 1/sqrt(d): without the slopes'
    pre-scale the output moves (the block parity above holds the scaled
    form to the JAX package's)."""
    _, _, _, _, family, cfg, params = falcon
    import torch

    from petals_tpu_torch.models.falcon import block as fblock
    from petals_tpu_torch.utils.convert import block_params_from_numpy

    tp = block_params_from_numpy(params, "cpu", torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 9, cfg.hidden_size)).astype(np.float32))
    kv = lambda: (torch.zeros(1, 9, cfg.num_kv_heads, cfg.head_dim),) * 2  # noqa: E731
    scaled, _ = family.block_apply(tp, x, tuple(z.clone() for z in kv()), 0, cfg)
    original = fblock.build_alibi_slopes
    fblock.build_alibi_slopes = lambda h, device=None: original(h, device) / (cfg.head_dim**-0.5)
    try:
        unscaled, _ = family.block_apply(tp, x, tuple(z.clone() for z in kv()), 0, cfg)
    finally:
        fblock.build_alibi_slopes = original
    assert (scaled - unscaled).abs().max().item() > 1e-3


@pytest.mark.parametrize("quant_type", ["none", "int8"])
def test_falcon_greedy_tokens_match_petals_tpu_server(tmp_path_factory, quant_type):
    path = make_tiny_falcon(str(tmp_path_factory.mktemp("models")), variant="7b", n_layers=2)
    port, jax_tokens = greedy_streams(path, 2, quant_type, [3, 17, 42, 5, 99])
    assert port == jax_tokens


def test_wide_groups_are_cut_into_tiles():
    """The attention kernels' wide-group arm (csrc/hopper_wgmma.cuh
    group_tiles, ops/attention.py the same rule): Falcon-7B's 71 query heads
    over one kv head are five tiles of at most 16 heads, the last ragged;
    Falcon-180B's group of 29 two; 16 and below one. The decode kernel's
    split plan counts a block a (kv head, tile)."""
    from petals_tpu_torch.ops.attention import GROUP_TILE, group_tiles
    from petals_tpu_torch.ops.paged_flash_attention import decode_split_plan

    assert [group_tiles(g) for g in (1, 4, 7, 16, 17, 29, 71)] == [
        (1, 1), (1, 4), (1, 7), (1, 16), (2, 9), (2, 15), (5, 15)]
    for group in range(1, 72):
        n, size = group_tiles(group)
        assert size <= GROUP_TILE and (n - 1) * size < group <= n * size
    # 8 lanes over one kv head on 132 SMs: 5 tiles make 40 blocks a split,
    # so 264 // 40 splits; one tile would take 33, capped at 1024 / 64 rows
    assert decode_split_plan(8, 1, 1024, 132, group=71) == 264 // 40
    assert decode_split_plan(8, 1, 1024, 132) == decode_split_plan(8, 1, 1024, 132, group=16) == 1024 // 64
    assert decode_split_plan(1, 8, 4096, 132, group=29) == 264 // 16
