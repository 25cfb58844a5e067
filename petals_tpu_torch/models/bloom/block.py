"""BLOOM decoder block as a plain function over a dict of tensors (weights
stored [in, out]), the port of petals_tpu/models/bloom/block.py: LayerNorms
with biases, the HF fused ``query_key_value`` split per head at load,
ALiBi (the slopes unscaled: the bias adds to the scores after their
``d**-0.5``), ``apply_residual_connection_post_layernorm`` and the
gelu-tanh MLP. The cache layout is every family's [batch, seq, heads, d]."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.bloom.config import BloomBlockConfig
from petals_tpu_torch.models.common import gelu_tanh, layer_norm, mm
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.alibi import build_alibi_slopes
from petals_tpu_torch.parallel.collectives import enter_tp, grid_layout, per_copy, reduce_shards
from petals_tpu_torch.parallel.sp import attend_shards, block_grid, block_sizes, join_rows, rank_rows, seq_ranks


def block_apply(
    params,  # one dict, a list of tp shard dicts, or GridParams (parallel/tp.py, parallel/sp.py)
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers, PagedKVs or ShardedCaches, written in place; None: stateless
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: BloomBlockConfig,
    *,
    n_valid=None,
    use_flash: bool = False,
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all)).
    Tensor and sequence parallel as the llama block (models/llama/block.py):
    each shard attends its own heads with those heads' ALiBi slopes (on
    global positions in the ring), and ``bo`` / ``b_down`` are added after
    the sums across the shards."""
    grid, grid_kv = block_grid(params, kv)
    lay = grid_layout(params)
    n, shard_ts, n_sp = block_sizes(params, grid, kv)
    h, d = cfg.num_attention_heads // n, cfg.head_dim
    eps = cfg.layer_norm_epsilon
    post_ln = cfg.apply_residual_connection_post_layernorm
    batch = hidden_states.shape[0]
    n_ranks = seq_ranks(n_sp, hidden_states.shape[1], kv, position, n_valid)
    streams, qkv = [], []
    for shards, x in zip(grid, rank_rows(hidden_states, n_ranks, lay)):
        hs = [x.to(p["ln1_w"].device) for p in shards]
        lns = per_copy(lambda x, w, b: layer_norm(x, w, b, eps), hs, [p["ln1_w"] for p in shards],
                       [p["ln1_b"] for p in shards])
        streams.append((hs, lns))
        rows = x.shape[1]
        qkv.append([tuple((mm(x1, p[w]) + p[b]).reshape(batch, rows, h, d) for w, b in WQKV)
                    for p, x1 in ((p, enter_tp(ln1, lay, n)) for p, ln1 in zip(shards, lns))])
    slopes = build_alibi_slopes(cfg.num_attention_heads, hidden_states.device)
    attn, kv_out = attend_shards(qkv, grid_kv, position, n_valid, use_flash, None,
                                 [slopes[t * h : (t + 1) * h] for t in shard_ts], n_ranks=n_ranks, layout=lay)
    outs = []
    for shards, (hs, lns), heads in zip(grid, streams, attn):
        rows = hs[0].shape[1]
        a = reduce_shards([mm(o.reshape(batch, rows, h * d), p["wo"]) for p, o in zip(shards, heads)], lay)
        a = per_copy(torch.add, a, [p["bo"] for p in shards])
        hs = per_copy(torch.add, a, lns if post_ln else hs)
        lns = per_copy(lambda x, w, b: layer_norm(x, w, b, eps), hs, [p["ln2_w"] for p in shards],
                       [p["ln2_b"] for p in shards])
        mlp = reduce_shards([mm(gelu_tanh(mm(enter_tp(ln2, lay, n), p["w_up"]) + p["b_up"]), p["w_down"])
                             for p, ln2 in zip(shards, lns)], lay)
        outs.append(mlp[0] + shards[0]["b_down"] + (lns[0] if post_ln else hs[0]))
    return join_rows(outs, n_ranks, lay), (kv_out if len(kv_out) > 1 else kv_out[0])


WQKV = (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))


# BLOOM checkpoints ship blocks as "h.{i}." (bare) or "transformer.h.{i}." (full model)
_HF_BLOCK_PREFIXES = ("h.{i}.", "transformer.h.{i}.")


def hf_to_block_params(tensors: dict, cfg: BloomBlockConfig) -> dict:
    """Map one block's HF tensors (names relative to the block prefix). The
    fused QKV's output axis is (heads, 3, dim), HF BloomAttention's
    packing; it is split into separate projections."""
    h, d, hidden = cfg.num_attention_heads, cfg.head_dim, cfg.hidden_size
    qkv_w = tensors["self_attention.query_key_value.weight"].reshape(h, 3, d, hidden)
    qkv_b = tensors["self_attention.query_key_value.bias"].reshape(h, 3, d)

    def t(name):
        return tensors[name].t().contiguous()

    return {
        "ln1_w": tensors["input_layernorm.weight"],
        "ln1_b": tensors["input_layernorm.bias"],
        "wq": qkv_w[:, 0].reshape(h * d, hidden).t().contiguous(),
        "bq": qkv_b[:, 0].reshape(h * d).contiguous(),
        "wk": qkv_w[:, 1].reshape(h * d, hidden).t().contiguous(),
        "bk": qkv_b[:, 1].reshape(h * d).contiguous(),
        "wv": qkv_w[:, 2].reshape(h * d, hidden).t().contiguous(),
        "bv": qkv_b[:, 2].reshape(h * d).contiguous(),
        "wo": t("self_attention.dense.weight"),
        "bo": tensors["self_attention.dense.bias"],
        "ln2_w": tensors["post_attention_layernorm.weight"],
        "ln2_b": tensors["post_attention_layernorm.bias"],
        "w_up": t("mlp.dense_h_to_4h.weight"),
        "b_up": tensors["mlp.dense_h_to_4h.bias"],
        "w_down": t("mlp.dense_4h_to_h.weight"),
        "b_down": tensors["mlp.dense_4h_to_h.bias"],
    }


def block_param_shapes(cfg: BloomBlockConfig, dtype=torch.bfloat16) -> dict:
    """The block's parameters as meta tensors (shape and dtype, no storage)."""
    h = cfg.hidden_size
    shapes = {
        "ln1_w": (h,), "ln1_b": (h,), "wq": (h, h), "bq": (h,), "wk": (h, h), "bk": (h,),
        "wv": (h, h), "bv": (h,), "wo": (h, h), "bo": (h,), "ln2_w": (h,), "ln2_b": (h,),
        "w_up": (h, 4 * h), "b_up": (4 * h,), "w_down": (4 * h, h), "b_down": (h,),
    }
    return {name: torch.empty(shape, dtype=dtype, device="meta") for name, shape in shapes.items()}


FAMILY = register_family(
    ModelFamily(
        name="bloom",
        block_arch="bloom",
        config_from_hf=BloomBlockConfig.from_hf_config,
        block_apply=block_apply,
        hf_block_prefixes=_HF_BLOCK_PREFIXES,
        hf_to_block_params=hf_to_block_params,
        block_param_shapes=block_param_shapes,
        supports_ring_attention=True,
    )
)
