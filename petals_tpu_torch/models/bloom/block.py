"""BLOOM decoder block as a plain function over a dict of tensors (weights
stored [in, out]), the port of petals_tpu/models/bloom/block.py: LayerNorms
with biases, the HF fused ``query_key_value`` split per head at load,
ALiBi (the slopes unscaled: the bias adds to the scores after their
``d**-0.5``), ``apply_residual_connection_post_layernorm`` and the
gelu-tanh MLP. The cache layout is every family's [batch, seq, heads, d]."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.bloom.config import BloomBlockConfig
from petals_tpu_torch.models.common import gelu_tanh, layer_norm, mm, update_kv_cache
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.alibi import build_alibi_slopes
from petals_tpu_torch.ops.attention import attend


def block_apply(
    params: dict,
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers or PagedKVs, written in place
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: BloomBlockConfig,
    *,
    n_valid=None,
    use_flash: bool = False,
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all))."""
    batch, seq, _ = hidden_states.shape
    h, d = cfg.num_attention_heads, cfg.head_dim

    ln1 = layer_norm(hidden_states, params["ln1_w"], params["ln1_b"], cfg.layer_norm_epsilon)
    residual = ln1 if cfg.apply_residual_connection_post_layernorm else hidden_states

    q = (mm(ln1, params["wq"]) + params["bq"]).reshape(batch, seq, h, d)
    k = (mm(ln1, params["wk"]) + params["bk"]).reshape(batch, seq, h, d)
    v = (mm(ln1, params["wv"]) + params["bv"]).reshape(batch, seq, h, d)

    k_all, v_all, kv_length = update_kv_cache(kv, k, v, position, n_valid)
    attn = attend(
        q, k_all, v_all, q_offset=position, kv_length=kv_length,
        alibi_slopes=build_alibi_slopes(h, hidden_states.device), use_flash=use_flash,
    )
    attn = mm(attn.reshape(batch, seq, h * d), params["wo"]) + params["bo"]
    hidden_states = attn + residual

    ln2 = layer_norm(hidden_states, params["ln2_w"], params["ln2_b"], cfg.layer_norm_epsilon)
    residual = ln2 if cfg.apply_residual_connection_post_layernorm else hidden_states
    mlp = mm(gelu_tanh(mm(ln2, params["w_up"]) + params["b_up"]), params["w_down"]) + params["b_down"]
    return mlp + residual, (k_all, v_all)


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
    )
)
