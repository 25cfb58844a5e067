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
from petals_tpu_torch.parallel.collectives import per_copy, reduce_shards
from petals_tpu_torch.parallel.tp import block_shards


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
    params,  # one dict, or a list of shard dicts (parallel/tp.py)
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers, PagedKVs or ShardedCaches, written in place
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: FalconBlockConfig,
    *,
    n_valid=None,
    use_flash: bool = False,
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all)).
    Tensor parallel as the llama block (models/llama/block.py): each shard
    attends its own heads (with those heads' ALiBi slopes on falcon-rw).
    The parallel layouts (falcon-7b, the new architecture) sum each shard's
    attention and MLP partials in ONE reduction; the serial layout
    (falcon-rw) reduces after the attention and again after the MLP; ``bo``
    and ``b_down`` are added after the sums."""
    shards, shard_kv = block_shards(params, kv)
    n = len(shards)
    serial = not cfg.new_decoder_architecture and not cfg.parallel_attn
    hs = [hidden_states.to(_device(p, cfg)) for p in shards]
    names = _norm_names(cfg)
    norms = per_copy(lambda x, *w: _norms(dict(zip(names, w)), x, cfg), hs, *[[p[k] for p in shards] for k in names])
    attn_parts, kv_out = [], []
    for rank, (p, (attn_ln, _), kv_s) in enumerate(zip(shards, norms, shard_kv)):
        attn, k_v = _attention(p, attn_ln, kv_s, position, cfg, n, rank, n_valid=n_valid, use_flash=use_flash)
        attn_parts.append(attn)
        kv_out.append(k_v)
    if serial:
        # the serial residual applies to old-architecture checkpoints only
        # (HF skips it when new_decoder_architecture is set)
        attn = _with_bias(reduce_shards(attn_parts), shards, "bo", cfg)
        hs = per_copy(torch.add, hs, attn)
        mlp_lns = per_copy(lambda x, w, b: layer_norm(x, w, b, cfg.layer_norm_epsilon), hs,
                           [p["ln2_w"] for p in shards], [p["ln2_b"] for p in shards])
        mlp = _with_bias(reduce_shards([_mlp(p, ln, cfg) for p, ln in zip(shards, mlp_lns)]), shards, "b_down", cfg)
        return mlp[0] + hs[0], (kv_out if n > 1 else kv_out[0])
    # parallel attention: mlp + attn, one sum across the shards
    both = reduce_shards([_mlp(p, mlp_ln, cfg) + a for p, (_, mlp_ln), a in zip(shards, norms, attn_parts)])
    both = _with_bias(_with_bias(both, shards, "b_down", cfg), shards, "bo", cfg)
    return both[0] + hs[0], (kv_out if n > 1 else kv_out[0])


def _device(p: dict, cfg: FalconBlockConfig) -> torch.device:
    return p["ln_attn_w" if _dual_ln(cfg) else "ln1_w"].device


def _with_bias(xs, shards, name: str, cfg: FalconBlockConfig):
    """The replicated bias ``name`` added to each shard's copy of a sum."""
    return per_copy(torch.add, xs, [p[name] for p in shards]) if cfg.bias else xs


def _norm_names(cfg: FalconBlockConfig) -> tuple:
    return ("ln_attn_w", "ln_attn_b", "ln_mlp_w", "ln_mlp_b") if _dual_ln(cfg) else ("ln1_w", "ln1_b")


def _norms(p: dict, x, cfg: FalconBlockConfig):
    """(attention input, MLP input) of the layout's norms; the serial
    layout's MLP input is recomputed after the attention's residual."""
    eps = cfg.layer_norm_epsilon
    if _dual_ln(cfg):
        return (layer_norm(x, p["ln_attn_w"], p["ln_attn_b"], eps), layer_norm(x, p["ln_mlp_w"], p["ln_mlp_b"], eps))
    ln = layer_norm(x, p["ln1_w"], p["ln1_b"], eps)
    return ln, ln


def _attention(p: dict, attn_ln, kv, position, cfg: FalconBlockConfig, n_shards: int, rank: int, *, n_valid,
               use_flash):
    """One shard's attention over its heads, up to its partial of the output
    projection (no ``bo``); returns (partial, (k_all, v_all))."""
    batch, seq, _ = attn_ln.shape
    hq, hkv, d = cfg.num_attention_heads // n_shards, cfg.num_kv_heads // n_shards, cfg.head_dim
    q = mm(attn_ln, p["wq"])
    k = mm(attn_ln, p["wk"])
    v = mm(attn_ln, p["wv"])
    if cfg.bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(batch, seq, hq, d)
    k = k.reshape(batch, seq, hkv, d)
    v = v.reshape(batch, seq, hkv, d)

    alibi_slopes = None
    if cfg.alibi:
        # Falcon scales (scores + alibi) jointly by 1/sqrt(d), where BLOOM
        # adds the bias unscaled: so the slopes are pre-scaled here
        slopes = build_alibi_slopes(cfg.num_attention_heads, attn_ln.device) * (d**-0.5)
        alibi_slopes = slopes[rank * hq : (rank + 1) * hq]
    else:
        positions = absolute_positions(position, batch, seq, attn_ln.device)
        cos, sin = rotary_tables(positions, d, theta=cfg.rope_theta)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

    k_all, v_all, kv_length = update_kv_cache(kv, k, v, position, n_valid)
    attn = attend(
        q, k_all, v_all, q_offset=position, kv_length=kv_length,
        alibi_slopes=alibi_slopes, use_flash=use_flash,
    )
    return mm(attn.reshape(batch, seq, hq * d), p["wo"]), (k_all, v_all)


def _mlp(p: dict, mlp_ln, cfg: FalconBlockConfig):
    """HF FalconMLP (dense_h_to_4h -> ACT2FN[config.activation] ->
    dense_4h_to_h) over the shard's columns, up to its partial of the down
    projection (no ``b_down``)."""
    mlp = mm(mlp_ln, p["w_up"])
    if cfg.bias:
        mlp = mlp + p["b_up"]
    return mm(_activation(mlp, cfg.activation), p["w_down"])


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
