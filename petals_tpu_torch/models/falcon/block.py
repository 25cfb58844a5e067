"""Falcon decoder block as a plain function over a dict of tensors (weights
stored [in, out]), the port of petals_tpu/models/falcon/block.py. It covers
the three layouts: the new decoder architecture (GQA, dual LayerNorms:
40B / 180B), falcon-7b (multi-query, parallel attention) and falcon-rw
(MHA with ALiBi, serial, with biases). The fused QKV is split at load for
each layout; the cache keeps the true kv heads and attention does the
grouping (Falcon-7B attends 71 query heads over one kv head)."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.common import absolute_positions, layer_norm, mm, update_kv_cache
from petals_tpu_torch.models.falcon.config import FalconBlockConfig
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.alibi import build_alibi_slopes
from petals_tpu_torch.ops.attention import attend
from petals_tpu_torch.ops.rotary import apply_rotary, rotary_tables


def _activation(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "gelu":
        return torch.nn.functional.gelu(x.float()).to(x.dtype)
    if name in ("gelu_pytorch_tanh", "gelu_new"):
        return torch.nn.functional.gelu(x.float(), approximate="tanh").to(x.dtype)
    if name == "relu":
        return torch.relu(x)
    raise NotImplementedError(f"Falcon activation {name!r} is not supported")


def _dual_ln(cfg: FalconBlockConfig) -> bool:
    """HF gates the dual-LN layout on the new architecture and num_ln == 2
    alone (parallel_attn is not consulted)."""
    return cfg.new_decoder_architecture and cfg.num_ln_in_parallel_attn == 2


def block_apply(
    params: dict,
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers or PagedKVs, written in place
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: FalconBlockConfig,
    *,
    n_valid=None,
    use_flash: bool = False,
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all))."""
    batch, seq, _ = hidden_states.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim
    residual = hidden_states

    if _dual_ln(cfg):
        attn_ln = layer_norm(hidden_states, params["ln_attn_w"], params["ln_attn_b"], cfg.layer_norm_epsilon)
        mlp_ln = layer_norm(hidden_states, params["ln_mlp_w"], params["ln_mlp_b"], cfg.layer_norm_epsilon)
    else:
        attn_ln = layer_norm(hidden_states, params["ln1_w"], params["ln1_b"], cfg.layer_norm_epsilon)
        mlp_ln = attn_ln  # parallel single-LN; the serial layout overwrites it below

    q = mm(attn_ln, params["wq"])
    k = mm(attn_ln, params["wk"])
    v = mm(attn_ln, params["wv"])
    if cfg.bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(batch, seq, hq, d)
    k = k.reshape(batch, seq, hkv, d)
    v = v.reshape(batch, seq, hkv, d)

    alibi_slopes = None
    if cfg.alibi:
        # Falcon scales (scores + alibi) jointly by 1/sqrt(d), where BLOOM
        # adds the bias unscaled: so the slopes are pre-scaled here
        alibi_slopes = build_alibi_slopes(hq, hidden_states.device) * (d**-0.5)
    else:
        positions = absolute_positions(position, batch, seq, hidden_states.device)
        cos, sin = rotary_tables(positions, d, theta=cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

    k_all, v_all, kv_length = update_kv_cache(kv, k, v, position, n_valid)
    attn = attend(
        q, k_all, v_all, q_offset=position, kv_length=kv_length,
        alibi_slopes=alibi_slopes, use_flash=use_flash,
    )
    attn = mm(attn.reshape(batch, seq, hq * d), params["wo"])
    if cfg.bias:
        attn = attn + params["bo"]

    # the serial residual applies to old-architecture checkpoints only (HF
    # skips it when new_decoder_architecture is set)
    if not cfg.new_decoder_architecture and not cfg.parallel_attn:
        residual = residual + attn
        mlp_ln = layer_norm(residual, params["ln2_w"], params["ln2_b"], cfg.layer_norm_epsilon)

    # HF FalconMLP: dense_h_to_4h -> ACT2FN[config.activation] -> dense_4h_to_h
    mlp = mm(mlp_ln, params["w_up"])
    if cfg.bias:
        mlp = mlp + params["b_up"]
    mlp = mm(_activation(mlp, cfg.activation), params["w_down"])
    if cfg.bias:
        mlp = mlp + params["b_down"]
    if cfg.new_decoder_architecture or cfg.parallel_attn:
        mlp = mlp + attn
    return mlp + residual, (k_all, v_all)


_HF_BLOCK_PREFIXES = ("transformer.h.{i}.", "h.{i}.")


def hf_to_block_params(tensors: dict, cfg: FalconBlockConfig) -> dict:
    """Map one block's HF tensors (names relative to the block prefix). The
    fused QKV's output axis is (hkv, group + 2, d) in the new architecture
    (each kv group's queries, then its k and v), (hq + 2, d) under
    multi_query (every query, then one k and one v), and (hq, 3, d)
    otherwise (falcon-rw's per-head interleave)."""
    hq, hkv, d, hidden = cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    group = hq // hkv

    def split(fused, tail):
        """(q, k, v) of the fused QKV, each [heads * d, *tail]."""
        if cfg.new_decoder_architecture:
            w = fused.reshape(hkv, group + 2, d, *tail)
            return w[:, :-2].reshape(hq * d, *tail), w[:, -2].reshape(hkv * d, *tail), w[:, -1].reshape(hkv * d, *tail)
        if cfg.multi_query:
            w = fused.reshape(hq + 2, d, *tail)
            return w[:-2].reshape(hq * d, *tail), w[-2].reshape(d, *tail), w[-1].reshape(d, *tail)
        w = fused.reshape(hq, 3, d, *tail)
        return tuple(w[:, j].reshape(hq * d, *tail) for j in range(3))

    def t(w):
        return w.t().contiguous()

    wq, wk, wv = split(tensors["self_attention.query_key_value.weight"], (hidden,))
    params = {
        "wq": t(wq), "wk": t(wk), "wv": t(wv),
        "wo": t(tensors["self_attention.dense.weight"]),
        "w_up": t(tensors["mlp.dense_h_to_4h.weight"]),
        "w_down": t(tensors["mlp.dense_4h_to_h.weight"]),
    }
    if _dual_ln(cfg):
        for ours, hf in (("ln_attn", "ln_attn"), ("ln_mlp", "ln_mlp")):
            params[f"{ours}_w"], params[f"{ours}_b"] = tensors[f"{hf}.weight"], tensors[f"{hf}.bias"]
    else:
        params["ln1_w"], params["ln1_b"] = tensors["input_layernorm.weight"], tensors["input_layernorm.bias"]
        if not cfg.parallel_attn and not cfg.new_decoder_architecture:
            params["ln2_w"] = tensors["post_attention_layernorm.weight"]
            params["ln2_b"] = tensors["post_attention_layernorm.bias"]
    if cfg.bias:
        bq, bk, bv = split(tensors["self_attention.query_key_value.bias"], ())
        params.update(
            bq=bq.contiguous(), bk=bk.contiguous(), bv=bv.contiguous(),
            bo=tensors["self_attention.dense.bias"],
            b_up=tensors["mlp.dense_h_to_4h.bias"],
            b_down=tensors["mlp.dense_4h_to_h.bias"],
        )
    return params


def block_param_shapes(cfg: FalconBlockConfig, dtype=torch.bfloat16) -> dict:
    """The block's parameters as meta tensors (shape and dtype, no storage)."""
    h, hq, hkv, d, f = cfg.hidden_size, cfg.num_attention_heads, cfg.num_kv_heads, cfg.head_dim, cfg.ffn_hidden_size
    shapes = {"wq": (h, hq * d), "wk": (h, hkv * d), "wv": (h, hkv * d), "wo": (hq * d, h),
              "w_up": (h, f), "w_down": (f, h)}
    if _dual_ln(cfg):
        shapes.update(ln_attn_w=(h,), ln_attn_b=(h,), ln_mlp_w=(h,), ln_mlp_b=(h,))
    else:
        shapes.update(ln1_w=(h,), ln1_b=(h,))
        if not cfg.parallel_attn and not cfg.new_decoder_architecture:
            shapes.update(ln2_w=(h,), ln2_b=(h,))
    if cfg.bias:
        shapes.update(bq=(hq * d,), bk=(hkv * d,), bv=(hkv * d,), bo=(h,), b_up=(f,), b_down=(h,))
    return {name: torch.empty(shape, dtype=dtype, device="meta") for name, shape in shapes.items()}


FAMILY = register_family(
    ModelFamily(
        name="falcon",
        block_arch="falcon",
        config_from_hf=FalconBlockConfig.from_hf_config,
        block_apply=block_apply,
        hf_block_prefixes=_HF_BLOCK_PREFIXES,
        hf_to_block_params=hf_to_block_params,
        block_param_shapes=block_param_shapes,
    )
)
