"""Llama decoder block as a plain function over a dict of tensors (weights
stored [in, out], as in petals_tpu/models/llama/block.py)."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.common import (
    ACTIVATIONS,
    absolute_positions,
    mm,
    rms_norm,
    update_kv_cache,
)
from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.attention import attend
from petals_tpu_torch.ops.rotary import apply_rotary, rotary_tables


def block_apply(
    params: dict,
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers or PagedKVs, written in place
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: LlamaBlockConfig,
    *,
    n_valid=None,  # count of real (non-padding) rows in this chunk
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all))."""
    batch, seq, _ = hidden_states.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    residual = hidden_states
    x = rms_norm(hidden_states, params["ln1"], cfg.rms_norm_eps)
    q = mm(x, params["wq"])
    k = mm(x, params["wk"])
    v = mm(x, params["wv"])
    if cfg.attention_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(batch, seq, hq, d)
    k = k.reshape(batch, seq, hkv, d)
    v = v.reshape(batch, seq, hkv, d)

    positions = absolute_positions(position, batch, seq, hidden_states.device)
    cos, sin = rotary_tables(positions, d, theta=cfg.rope_theta, rope_scaling=cfg.rope_scaling_dict)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    k_all, v_all, kv_length = update_kv_cache(kv, k, v, position, n_valid)
    attn = attend(
        q, k_all, v_all, q_offset=position, kv_length=kv_length,
        sliding_window=cfg.sliding_window,  # mistral; None for llama
    )
    attn = mm(attn.reshape(batch, seq, hq * d), params["wo"])
    if cfg.attention_bias:
        attn = attn + params["bo"]
    hidden_states = residual + attn

    residual = hidden_states
    x = rms_norm(hidden_states, params["ln2"], cfg.rms_norm_eps)
    gate = mm(x, params["wg"])
    up = mm(x, params["wu"])
    if cfg.mlp_bias:
        gate = gate + params["bg"]
        up = up + params["bu"]
    mlp = mm(ACTIVATIONS[cfg.hidden_act](gate) * up, params["wd"])
    if cfg.mlp_bias:
        mlp = mlp + params["bd"]
    return residual + mlp, (k_all, v_all)


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
    if cfg.attention_bias:
        for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj"), ("bo", "o_proj")):
            params[ours] = tensors[f"self_attn.{hf}.bias"]
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
    if cfg.attention_bias:
        shapes.update(bq=(hq * d,), bk=(hkv * d,), bv=(hkv * d,), bo=(h,))
    if cfg.mlp_bias:
        shapes.update(bg=(m,), bu=(m,), bd=(h,))
    return {name: torch.empty(shape, dtype=dtype, device="meta") for name, shape in shapes.items()}


FAMILY = register_family(
    ModelFamily(
        name="llama",
        config_from_hf=LlamaBlockConfig.from_hf_config,
        block_apply=block_apply,
        hf_block_prefixes=_HF_BLOCK_PREFIXES,
        hf_to_block_params=hf_to_block_params,
        block_param_shapes=block_param_shapes,
    )
)
