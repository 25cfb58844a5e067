"""Llama decoder block as a plain function over a dict of tensors (weights
stored [in, out], as in petals_tpu/models/llama/block.py). A weight may be
dense or quantized (``mm`` dispatches), and a quantized block may carry the
fused ``wqkv`` / ``wgu`` leaves in place of the separate projections."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.common import (
    ACTIVATIONS,
    absolute_positions,
    mm,
    rms_norm,
)
from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from petals_tpu_torch.parallel.collectives import enter_tp, grid_layout, per_copy, reduce_shards
from petals_tpu_torch.parallel.sp import attend_shards, block_grid, block_sizes, join_rows, rank_rows, seq_ranks


def block_apply(
    params,  # one dict, a list of tp shard dicts, or GridParams (parallel/tp.py, parallel/sp.py)
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers, PagedKVs or ShardedCaches, written in place; None: stateless
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: LlamaBlockConfig,
    *,
    n_valid=None,  # count of real (non-padding) rows in this chunk
    n_total=None,  # the final sequence length when known up front (longrope's factor choice)
    use_flash: bool = False,  # dense buffers: route chunks of >= 8 rows to the flash kernel
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all)).

    Tensor parallel when ``params`` is a list of shard dicts: each shard
    computes its heads and FFN columns on its own device from its copy of
    the residual stream, the partial outputs of the attention output
    projection and of the down projection are summed across the shards
    (``reduce_shards``), and the replicated biases are added after each sum.
    Sequence parallel over ``GridParams``' sp ranks: the chunk's rows split
    over the ranks (``seq_ranks``), each rank runs the shards on its rows,
    and the ranks meet in attention (``attend_maybe_ring``). One rank of one
    shard is the unsharded block. Returns hidden on rank 0's first device
    and each shard's (k_all, v_all) as a list when sharded (None without a
    cache). Across processes (``GridParams`` with a layout) the shards and
    ranks are this process's, and the sums and attention meet the others'
    (parallel/collectives.py)."""
    grid, grid_kv = block_grid(params, kv)
    lay = grid_layout(params)
    n, _, n_sp = block_sizes(params, grid, kv)
    eps = cfg.rms_norm_eps
    batch, seq, _ = hidden_states.shape
    n_ranks = seq_ranks(n_sp, seq, kv, position, n_valid)
    positions = absolute_positions(position, batch, seq, hidden_states.device)
    cos, sin = rotary_tables(
        positions, cfg.head_dim, theta=cfg.rope_theta, rope_scaling=cfg.rope_scaling_dict,
        n_valid=n_valid,  # longrope's switch sees the REAL chunk length
        n_total=n_total,  # ...or the full prompt length when it is known up front
    )
    streams, qkv = [], []
    for shards, x, c, s in zip(grid, rank_rows(hidden_states, n_ranks, lay), rank_rows(cos, n_ranks, lay),
                               rank_rows(sin, n_ranks, lay)):
        hs = [x.to(p["ln1"].device) for p in shards]  # the residual stream, one copy a device
        normed = per_copy(lambda h, w: rms_norm(h, w, eps), hs, [p["ln1"] for p in shards])
        streams.append(hs)
        qkv.append([_qkv(p, enter_tp(y, lay, n), c, s, cfg, n) for p, y in zip(shards, normed)])
    attn, kv_out = attend_shards(qkv, grid_kv, position, n_valid, use_flash, cfg.sliding_window, n_ranks=n_ranks,
                                 layout=lay)
    outs = []
    for shards, hs, heads in zip(grid, streams, attn):
        rows = hs[0].shape[1]
        a = reduce_shards([mm(o.reshape(batch, rows, -1), p["wo"]) for p, o in zip(shards, heads)], lay)
        if cfg.attention_bias:
            a = per_copy(torch.add, a, [p["bo"] for p in shards])
        hs = per_copy(torch.add, hs, a)
        normed = per_copy(lambda h, w: rms_norm(h, w, eps), hs, [p["ln2"] for p in shards])
        mlp = reduce_shards([_mlp(p, enter_tp(x, lay, n), cfg) for p, x in zip(shards, normed)], lay)
        if cfg.mlp_bias:
            mlp = per_copy(torch.add, mlp, [p["bd"] for p in shards])
        outs.append(hs[0] + mlp[0])
    return join_rows(outs, n_ranks, lay), (kv_out if len(kv_out) > 1 else kv_out[0])


def _qkv(p: dict, x, cos, sin, cfg: LlamaBlockConfig, n_shards: int):
    """One shard's queries, keys and values over its hq / N query and hkv /
    N kv heads, rotated with the rows' ``cos`` / ``sin``."""
    batch, seq, _ = x.shape
    hq, hkv, d = cfg.num_attention_heads // n_shards, cfg.num_key_value_heads // n_shards, cfg.head_dim
    if "wqkv" in p:  # fused quantized serving (utils/convert_block.py _FUSE_GROUPS), one shard only
        qkv = mm(x, p["wqkv"])
        if cfg.attention_bias or cfg.qkv_bias:
            qkv = qkv + p["bqkv"]
        q = qkv[..., : hq * d]
        k = qkv[..., hq * d : (hq + hkv) * d]
        v = qkv[..., (hq + hkv) * d :]
    else:
        q = mm(x, p["wq"])
        k = mm(x, p["wk"])
        v = mm(x, p["wv"])
        if cfg.attention_bias or cfg.qkv_bias:
            q = q + p["bq"]
            k = k + p["bk"]
            v = v + p["bv"]
    cos, sin = cos.to(x.device), sin.to(x.device)
    q = apply_rotary(q.reshape(batch, seq, hq, d), cos, sin)
    k = apply_rotary(k.reshape(batch, seq, hkv, d), cos, sin)
    return q, k, v.reshape(batch, seq, hkv, d)


def _mlp(p: dict, x, cfg: LlamaBlockConfig):
    """One shard's MLP over its FFN columns, up to its partial of the down
    projection (no ``bd``)."""
    if "wgu" in p:  # fused quantized serving, one shard only
        gu = mm(x, p["wgu"])
        if cfg.mlp_bias:
            gu = gu + p["bgu"]
        half = gu.shape[-1] // 2
        gate, up = gu[..., :half], gu[..., half:]
    else:
        gate = mm(x, p["wg"])
        up = mm(x, p["wu"])
        if cfg.mlp_bias:
            gate = gate + p["bg"]
            up = up + p["bu"]
    return mm(ACTIVATIONS[cfg.hidden_act](gate) * up, p["wd"])


# HF checkpoints store weights torch-style [out, in]; blocks keep [in, out]
_HF_BLOCK_PREFIXES = ("model.layers.{i}.",)


def hf_to_block_params(tensors: dict, cfg: LlamaBlockConfig) -> dict:
    """Map one block's HF tensors (names relative to the block prefix)."""

    def t(name):
        return tensors[name].t().contiguous()

    params = {
        "ln1": tensors["input_layernorm.weight"],
        "wq": t("self_attn.q_proj.weight"),
        "wk": t("self_attn.k_proj.weight"),
        "wv": t("self_attn.v_proj.weight"),
        "wo": t("self_attn.o_proj.weight"),
        "ln2": tensors["post_attention_layernorm.weight"],
        "wg": t("mlp.gate_proj.weight"),
        "wu": t("mlp.up_proj.weight"),
        "wd": t("mlp.down_proj.weight"),
    }
    if cfg.attention_bias or cfg.qkv_bias:
        for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            params[ours] = tensors[f"self_attn.{hf}.bias"]
    if cfg.attention_bias:  # qwen2's o_proj has none
        params["bo"] = tensors["self_attn.o_proj.bias"]
    if cfg.mlp_bias:
        for ours, hf in (("bg", "gate_proj"), ("bu", "up_proj"), ("bd", "down_proj")):
            params[ours] = tensors[f"mlp.{hf}.bias"]
    return params


def block_param_shapes(cfg: LlamaBlockConfig, dtype=torch.bfloat16) -> dict:
    """The block's parameters as meta tensors (shape and dtype, no storage)."""
    h, hq, hkv, d, m = (
        cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
        cfg.head_dim, cfg.intermediate_size,
    )
    shapes = {
        "ln1": (h,), "wq": (h, hq * d), "wk": (h, hkv * d), "wv": (h, hkv * d),
        "wo": (hq * d, h), "ln2": (h,), "wg": (h, m), "wu": (h, m), "wd": (m, h),
    }
    if cfg.attention_bias or cfg.qkv_bias:
        shapes.update(bq=(hq * d,), bk=(hkv * d,), bv=(hkv * d,))
    if cfg.attention_bias:
        shapes.update(bo=(h,))
    if cfg.mlp_bias:
        shapes.update(bg=(m,), bu=(m,), bd=(h,))
    return {name: torch.empty(shape, dtype=dtype, device="meta") for name, shape in shapes.items()}


FAMILY = register_family(
    ModelFamily(
        name="llama",
        block_arch="llama",
        config_from_hf=LlamaBlockConfig.from_hf_config,
        block_apply=block_apply,
        hf_block_prefixes=_HF_BLOCK_PREFIXES,
        hf_to_block_params=hf_to_block_params,
        block_param_shapes=block_param_shapes,
        supports_ring_attention=True,
    )
)
