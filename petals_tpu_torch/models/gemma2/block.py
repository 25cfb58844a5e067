"""Gemma-2 decoder block (petals_tpu/models/gemma2/block.py), a plain
function over a dict of tensors (weights [in, out]):

- four (1 + w)-folded RMSNorms, the post-norms applied to each sublayer's
  output before the residual add;
- the query scale ``query_pre_attn_scalar ** -0.5``, not head_dim's;
- the attention logit softcap, tanh(l / cap) * cap after the scale and
  before the mask, which every attention kernel applies (ops/attention.py);
- alternating sliding and full attention: block i's window is the leaf
  ``attn_window`` (``sliding_window`` where ``layer_types[i]`` is
  "sliding_attention", else 0 for full attention). It is a HOST int, fixed
  at load: each block's kernel launches take it as an argument, so a
  captured step bakes in each block's own window and no step reads it on
  the card;
- GeGLU (the tanh GeLU), with the fused ``wqkv`` / ``wgu`` leaves of a
  quantized span as the llama block has them.
"""

from __future__ import annotations

import torch

from petals_tpu_torch.models.common import ACTIVATIONS, absolute_positions, mm, rms_norm, update_kv_cache
from petals_tpu_torch.models.gemma import fold_norm
from petals_tpu_torch.models.gemma2.config import Gemma2BlockConfig
from petals_tpu_torch.ops.attention import attend
from petals_tpu_torch.ops.rotary import apply_rotary, rotary_tables


def block_apply(
    params: dict,
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers or PagedKVs, written in place
    position,  # int, 0-dim tensor or [batch] tensor (per-lane decode)
    cfg: Gemma2BlockConfig,
    *,
    n_valid=None,  # count of real (non-padding) rows in this chunk
    use_flash: bool = False,  # dense buffers: route chunks of >= 8 rows to the flash kernel
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all))."""
    batch, seq, _ = hidden_states.shape
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    residual = hidden_states
    x = rms_norm(hidden_states, params["ln1"], cfg.rms_norm_eps)
    if "wqkv" in params:  # fused quantized serving (utils/convert_block.py _FUSE_GROUPS)
        qkv = mm(x, params["wqkv"])
        q = qkv[..., : hq * d]
        k = qkv[..., hq * d : (hq + hkv) * d]
        v = qkv[..., (hq + hkv) * d :]
    else:
        q = mm(x, params["wq"])
        k = mm(x, params["wk"])
        v = mm(x, params["wv"])
    q = q.reshape(batch, seq, hq, d)
    k = k.reshape(batch, seq, hkv, d)
    v = v.reshape(batch, seq, hkv, d)

    positions = absolute_positions(position, batch, seq, hidden_states.device)
    cos, sin = rotary_tables(positions, d, theta=cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    k_all, v_all, kv_length = update_kv_cache(kv, k, v, position, n_valid)
    window = int(params["attn_window"])  # a host int (0: full attention)
    attn = attend(
        q, k_all, v_all, q_offset=position, kv_length=kv_length,
        sliding_window=window if window > 0 else None,
        scale=float(cfg.query_pre_attn_scalar) ** -0.5,
        logit_softcap=cfg.attn_logit_softcapping,
        use_flash=use_flash,
    )
    attn = mm(attn.reshape(batch, seq, hq * d), params["wo"])
    attn = rms_norm(attn, params["ln1_post"], cfg.rms_norm_eps)
    hidden_states = residual + attn

    residual = hidden_states
    x = rms_norm(hidden_states, params["ln2_pre"], cfg.rms_norm_eps)
    if "wgu" in params:  # fused quantized serving
        gu = mm(x, params["wgu"])
        gate = gu[..., : cfg.intermediate_size]
        up = gu[..., cfg.intermediate_size :]
    else:
        gate = mm(x, params["wg"])
        up = mm(x, params["wu"])
    mlp = mm(ACTIVATIONS[cfg.hidden_act](gate) * up, params["wd"])
    mlp = rms_norm(mlp, params["ln2_post"], cfg.rms_norm_eps)
    return residual + mlp, (k_all, v_all)


_HF_BLOCK_PREFIXES = ("model.layers.{i}.",)


def block_window(cfg: Gemma2BlockConfig, block_index: int) -> int:
    """Block ``block_index``'s attention window: ``sliding_window`` on a
    sliding layer, 0 (full attention) on a full one."""
    return int(cfg.sliding_window) if cfg.layer_types[block_index] == "sliding_attention" else 0


def hf_to_block_params(tensors: dict, cfg: Gemma2BlockConfig, block_index: int) -> dict:
    """Map one block's HF tensors; ``block_index`` is required (no default),
    as in petals_tpu: a loader that dropped it would stamp one window on
    every block."""

    def t(name):
        return tensors[name].t().contiguous()

    return {
        "ln1": fold_norm(tensors["input_layernorm.weight"]),
        "ln1_post": fold_norm(tensors["post_attention_layernorm.weight"]),
        "ln2_pre": fold_norm(tensors["pre_feedforward_layernorm.weight"]),
        "ln2_post": fold_norm(tensors["post_feedforward_layernorm.weight"]),
        "wq": t("self_attn.q_proj.weight"),
        "wk": t("self_attn.k_proj.weight"),
        "wv": t("self_attn.v_proj.weight"),
        "wo": t("self_attn.o_proj.weight"),
        "wg": t("mlp.gate_proj.weight"),
        "wu": t("mlp.up_proj.weight"),
        "wd": t("mlp.down_proj.weight"),
        "attn_window": block_window(cfg, block_index),
    }


def block_param_shapes(cfg: Gemma2BlockConfig, dtype=torch.bfloat16) -> dict:
    """The block's parameters as meta tensors (the folded norms float32, the
    window an int32 scalar, as petals_tpu's shapes say)."""
    h, hq, hkv, d, m = (
        cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.intermediate_size,
    )
    shapes = {
        "ln1": ((h,), torch.float32), "ln1_post": ((h,), torch.float32), "ln2_pre": ((h,), torch.float32),
        "ln2_post": ((h,), torch.float32), "wq": ((h, hq * d), dtype), "wk": ((h, hkv * d), dtype),
        "wv": ((h, hkv * d), dtype), "wo": ((hq * d, h), dtype), "wg": ((h, m), dtype), "wu": ((h, m), dtype),
        "wd": ((m, h), dtype), "attn_window": ((), torch.int32),
    }
    return {name: torch.empty(shape, dtype=dt, device="meta") for name, (shape, dt) in shapes.items()}
