"""Falcon decoder block as a plain function over a dict of tensors (weights
stored [in, out]), the port of petals_tpu/models/falcon/block.py. It covers
the three layouts: the new decoder architecture (GQA, dual LayerNorms:
40B / 180B), falcon-7b (multi-query, parallel attention) and falcon-rw
(MHA with ALiBi, serial, with biases). The fused QKV is split at load for
each layout; the cache keeps the true kv heads and attention does the
grouping (Falcon-7B attends 71 query heads over one kv head)."""

from __future__ import annotations

import torch

from petals_tpu_torch.models.common import absolute_positions, layer_norm, mm
from petals_tpu_torch.models.falcon.config import FalconBlockConfig
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.alibi import build_alibi_slopes
from petals_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from petals_tpu_torch.parallel.collectives import enter_tp, grid_layout, per_copy, reduce_shards
from petals_tpu_torch.parallel.sp import attend_shards, block_grid, block_sizes, join_rows, rank_rows, seq_ranks


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
    params,  # one dict, a list of tp shard dicts, or GridParams (parallel/tp.py, parallel/sp.py)
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers, PagedKVs or ShardedCaches, written in place; None: stateless
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: FalconBlockConfig,
    *,
    n_valid=None,
    use_flash: bool = False,
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all)).
    Tensor and sequence parallel as the llama block (models/llama/block.py):
    each shard attends its own heads (with those heads' ALiBi slopes on
    falcon-rw). The parallel layouts (falcon-7b, the new architecture) sum
    each shard's attention and MLP partials in ONE reduction; the serial
    layout (falcon-rw) reduces after the attention and again after the MLP;
    ``bo`` and ``b_down`` are added after the sums."""
    grid, grid_kv = block_grid(params, kv)
    lay = grid_layout(params)
    n, shard_ts, n_sp = block_sizes(params, grid, kv)
    serial = not cfg.new_decoder_architecture and not cfg.parallel_attn
    batch, seq, _ = hidden_states.shape
    n_ranks = seq_ranks(n_sp, seq, kv, position, n_valid)
    names = _norm_names(cfg)
    d = cfg.head_dim
    slopes = rotary = None
    if cfg.alibi:
        # Falcon scales (scores + alibi) jointly by 1/sqrt(d), where BLOOM
        # adds the bias unscaled: so the slopes are pre-scaled here
        hq = cfg.num_attention_heads // n
        scaled = build_alibi_slopes(cfg.num_attention_heads, hidden_states.device) * (d**-0.5)
        slopes = [scaled[t * hq : (t + 1) * hq] for t in shard_ts]
    else:
        positions = absolute_positions(position, batch, seq, hidden_states.device)
        rotary = rotary_tables(positions, d, theta=cfg.rope_theta)
    rank_tables = zip(*(rank_rows(t, n_ranks, lay) for t in rotary)) if rotary else [None] * len(grid)
    streams, qkv = [], []
    for shards, x, tables in zip(grid, rank_rows(hidden_states, n_ranks, lay), rank_tables):
        hs = [x.to(_device(p, cfg)) for p in shards]
        norms = per_copy(lambda x, *w: _norms(dict(zip(names, w)), x, cfg), hs,
                         *[[p[k] for p in shards] for k in names])
        streams.append((hs, norms))
        qkv.append([_qkv(p, enter_tp(attn_ln, lay, n), tables, cfg, n) for p, (attn_ln, _) in zip(shards, norms)])
    attn, kv_out = attend_shards(qkv, grid_kv, position, n_valid, use_flash, None, slopes, n_ranks=n_ranks,
                                 layout=lay)
    outs = []
    for shards, (hs, norms), heads in zip(grid, streams, attn):
        rows = hs[0].shape[1]
        attn_parts = [mm(o.reshape(batch, rows, -1), p["wo"]) for p, o in zip(shards, heads)]
        if serial:
            # the serial residual applies to old-architecture checkpoints only
            # (HF skips it when new_decoder_architecture is set)
            a = _with_bias(reduce_shards(attn_parts, lay), shards, "bo", cfg)
            hs = per_copy(torch.add, hs, a)
            mlp_lns = per_copy(lambda x, w, b: layer_norm(x, w, b, cfg.layer_norm_epsilon), hs,
                               [p["ln2_w"] for p in shards], [p["ln2_b"] for p in shards])
            mlp = _with_bias(reduce_shards([_mlp(p, enter_tp(ln, lay, n), cfg) for p, ln in zip(shards, mlp_lns)], lay),
                             shards, "b_down", cfg)
            outs.append(mlp[0] + hs[0])
            continue
        # parallel attention: mlp + attn, one sum across the shards
        both = reduce_shards([_mlp(p, enter_tp(mlp_ln, lay, n), cfg) + a
                              for p, (_, mlp_ln), a in zip(shards, norms, attn_parts)], lay)
        both = _with_bias(_with_bias(both, shards, "b_down", cfg), shards, "bo", cfg)
        outs.append(both[0] + hs[0])
    return join_rows(outs, n_ranks, lay), (kv_out if len(kv_out) > 1 else kv_out[0])


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


def _qkv(p: dict, attn_ln, rotary, cfg: FalconBlockConfig, n_shards: int):
    """One shard's queries, keys and values over its heads, rotated with the
    rows' (cos, sin) unless the layout takes ALiBi (``rotary`` None)."""
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
    if rotary is not None:
        cos, sin = (t.to(attn_ln.device) for t in rotary)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v.reshape(batch, seq, hkv, d)


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
        supports_ring_attention=True,
    )
)
