"""Mixtral (MoE) decoder block as a plain function over a dict of tensors
(weights stored [in, out]; the experts stacked [E, in, out]), the port of
petals_tpu/models/mixtral/block.py: llama's attention (GQA, rotary, an
optional sliding window) and a mixture of top-k experts with HF's routing
(softmax in float32, top-k, renormalized).

Two dispatch modes, as the reference's:

- DENSE (decode, and quantized experts at every length): every expert runs
  over every row and a per-expert combine weight keeps the top-k. Quantized
  experts run one expert at a time through ``mm`` (the dequant-matmul
  kernels on the card), so dense expert weights never exist.
- SPARSE (chunks of at least ``SPARSE_MIN_SEQ`` rows, the chunk's padded
  length, with dense experts): the assignments are sorted by expert and the
  three projections run as grouped products (ops/grouped_matmul.py, K7 on
  the card), so prefill work scales with top-k, not E. Every op keeps its
  sizes on the device (the group sizes are a scatter-add over the static E,
  not a bincount, which syncs on CUDA), so a captured mixed step replays it.
"""

from __future__ import annotations

import torch

from petals_tpu_torch.models.common import absolute_positions, mm, rms_norm, silu
from petals_tpu_torch.models.mixtral.config import MixtralBlockConfig
from petals_tpu_torch.models.registry import ModelFamily, register_family
from petals_tpu_torch.ops.grouped_matmul import grouped_matmul
from petals_tpu_torch.ops.quant import QuantizedLinear
from petals_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from petals_tpu_torch.parallel.collectives import enter_tp, grid_layout, per_copy, reduce_shards
from petals_tpu_torch.parallel.sp import (
    GridParams,
    attend_shards,
    block_grid,
    block_sizes,
    join_rows,
    rank_rows,
    seq_ranks,
)

# chunks of at least this many rows (padded) take the sparse dispatch
SPARSE_MIN_SEQ = 8


def route(x: torch.Tensor, gate: torch.Tensor, k: int):
    """HF's routing: softmax of the router's logits in float32, the top k
    (the lower expert first on a tie, as ``jax.lax.top_k``: a stable sort,
    where ``torch.topk`` promises no order on CUDA), renormalized. Returns
    (probs [..., k] float32, experts [..., k] int64)."""
    probs = torch.softmax((x @ gate).float(), dim=-1)
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_probs, top_idx = top_probs[..., :k], top_idx[..., :k]
    return top_probs / top_probs.sum(dim=-1, keepdim=True), top_idx


def _moe_sparse(x, w1, w2, w3, top_idx, top_probs, cfg) -> torch.Tensor:
    """The grouped dispatch: work proportional to rows x top_k."""
    b, s, h = x.shape
    E, k = cfg.num_local_experts, cfg.num_experts_per_tok
    n_assign = b * s * k
    flat_experts = top_idx.reshape(n_assign)
    _, order = torch.sort(flat_experts, stable=True)  # assignments grouped by expert
    token_of = order // k
    xg = x.reshape(b * s, h).index_select(0, token_of)  # [n_assign, h]
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device).scatter_add_(
        0, flat_experts, torch.ones(n_assign, dtype=torch.int32, device=x.device))
    g1 = grouped_matmul(xg, w1, group_sizes)
    g3 = grouped_matmul(xg, w3, group_sizes)
    out = grouped_matmul(silu(g1) * g3, w2, group_sizes)  # [n_assign, h]
    wts = top_probs.reshape(n_assign).index_select(0, order).float()
    # the combine in float32, as the reference's scatter-add. On the card
    # index_add_ adds with atomics in no fixed order; each row takes its
    # top_k adds onto zero, and at top-2 (Mixtral's) 0 + a + b equals
    # 0 + b + a exactly, so the order cannot change the result
    y = torch.zeros((b * s, h), dtype=torch.float32, device=x.device)
    y.index_add_(0, token_of, out.float() * wts[:, None])
    return y.to(x.dtype).reshape(b, s, h)


def _expert(w: QuantizedLinear, e: int) -> QuantizedLinear:
    """Expert e of a quantized [E, in, out] stack."""
    return QuantizedLinear(w.kind, w.data[e], w.scales[e], w.in_features, w.out_features)


def moe_apply(params: dict, x: torch.Tensor, cfg: MixtralBlockConfig, *, sparse: bool = False,
              n_shards: int = 1, rank: int = 0) -> torch.Tensor:
    """x [batch, seq, hidden] -> the mixture of its top-k experts. A shard
    of a tensor-parallel block (``rank`` of ``n_shards``) holds experts
    [rank * E / N, (rank + 1) * E / N) and returns their part of the
    mixture, dense: the router is replicated, and the other shards' experts
    weigh nothing here."""
    top_probs, top_idx = route(x, params["gate"], cfg.num_experts_per_tok)
    w1, w2, w3 = params["w1"], params["w2"], params["w3"]
    quantized = isinstance(w1, QuantizedLinear)
    if sparse and not quantized and n_shards == 1:
        return _moe_sparse(x, w1, w2, w3, top_idx, top_probs, cfg)

    # each expert's combine weight [b, s, E] (the top-k's probabilities,
    # zero elsewhere), rounded to x's dtype as the reference rounds it
    E = cfg.num_local_experts
    combine = torch.zeros((*x.shape[:2], E), dtype=torch.float32, device=x.device)
    combine = combine.scatter_add_(-1, top_idx, top_probs).to(x.dtype)
    local = E // n_shards
    combine = combine[..., rank * local : (rank + 1) * local]
    if quantized:
        expert_out = torch.stack([
            mm(silu(mm(x, _expert(w1, e))) * mm(x, _expert(w3, e)), _expert(w2, e))
            for e in range(local)
        ])  # [E / N, b, s, h]
    else:
        gate_out = torch.einsum("bsh,ehm->ebsm", x, w1)
        up = torch.einsum("bsh,ehm->ebsm", x, w3)
        expert_out = torch.einsum("ebsm,emh->ebsh", silu(gate_out) * up, w2)
    return torch.einsum("ebsh,bse->bsh", expert_out, combine)


def block_apply(
    params,  # one dict, a list of tp shard dicts, or GridParams (parallel/tp.py, parallel/sp.py)
    hidden_states: torch.Tensor,  # [batch, seq, hidden]
    kv,  # (k, v): dense buffers, PagedKVs or ShardedCaches, written in place; None: stateless
    position,  # int (tokens already cached) or [batch] tensor (per-lane decode)
    cfg: MixtralBlockConfig,
    *,
    n_valid=None,
    use_flash: bool = False,
):
    """One block over ``hidden_states``; returns (hidden, (k_all, v_all)).
    Tensor and sequence parallel as the llama block (models/llama/block.py)
    for the attention; the experts split over the tp shards (expert
    parallelism, as the JAX package's spec) and take the dense dispatch at
    every length under any mesh, as the JAX package's do."""
    grid, grid_kv = block_grid(params, kv)
    lay = grid_layout(params)
    n, shard_ts, n_sp = block_sizes(params, grid, kv)
    meshed = n > 1 or isinstance(params, GridParams)
    eps = cfg.rms_norm_eps
    batch, seq, _ = hidden_states.shape
    n_ranks = seq_ranks(n_sp, seq, kv, position, n_valid)
    positions = absolute_positions(position, batch, seq, hidden_states.device)
    cos, sin = rotary_tables(positions, cfg.head_dim, theta=cfg.rope_theta)
    streams, qkv = [], []
    for shards, x, c, s in zip(grid, rank_rows(hidden_states, n_ranks, lay), rank_rows(cos, n_ranks, lay),
                               rank_rows(sin, n_ranks, lay)):
        hs = [x.to(p["ln1"].device) for p in shards]
        normed = per_copy(lambda h, w: rms_norm(h, w, eps), hs, [p["ln1"] for p in shards])
        streams.append(hs)
        qkv.append([_qkv(p, enter_tp(y, lay, n), c, s, cfg, n) for p, y in zip(shards, normed)])
    attn, kv_out = attend_shards(qkv, grid_kv, position, n_valid, use_flash, cfg.sliding_window, n_ranks=n_ranks,
                                 layout=lay)
    outs = []
    for shards, hs, heads in zip(grid, streams, attn):
        rows = hs[0].shape[1]
        hs = per_copy(torch.add, hs, reduce_shards([mm(o.reshape(batch, rows, -1), p["wo"])
                                                    for p, o in zip(shards, heads)], lay))
        # under autograd (a server's backward recompute) the dense path: K7
        # has no backward, and the dense einsums differentiate as they stand
        sparse = rows >= SPARSE_MIN_SEQ and not torch.is_grad_enabled() and not meshed
        normed = per_copy(lambda h, w: rms_norm(h, w, eps), hs, [p["ln2"] for p in shards])
        moe = reduce_shards([moe_apply(p, enter_tp(x, lay, n), cfg, sparse=sparse, n_shards=n, rank=t)
                             for t, p, x in zip(shard_ts, shards, normed)], lay)
        outs.append(hs[0] + moe[0])
    return join_rows(outs, n_ranks, lay), (kv_out if len(kv_out) > 1 else kv_out[0])


def _qkv(p: dict, x, cos, sin, cfg: MixtralBlockConfig, n_shards: int):
    """One shard's rotated queries, keys and values over its heads."""
    batch, seq, _ = x.shape
    hq, hkv, d = cfg.num_attention_heads // n_shards, cfg.num_key_value_heads // n_shards, cfg.head_dim
    cos, sin = cos.to(x.device), sin.to(x.device)
    q = apply_rotary(mm(x, p["wq"]).reshape(batch, seq, hq, d), cos, sin)
    k = apply_rotary(mm(x, p["wk"]).reshape(batch, seq, hkv, d), cos, sin)
    return q, k, mm(x, p["wv"]).reshape(batch, seq, hkv, d)


_HF_BLOCK_PREFIXES = ("model.layers.{i}.",)


def hf_to_block_params(tensors: dict, cfg: MixtralBlockConfig) -> dict:
    """Map one block's HF tensors (names relative to the block prefix); each
    projection's experts are stacked [E, in, out]."""

    def t(name):
        return tensors[name].t().contiguous()

    def experts(w):
        return torch.stack([t(f"block_sparse_moe.experts.{e}.{w}.weight") for e in range(cfg.num_local_experts)])

    return {
        "ln1": tensors["input_layernorm.weight"],
        "wq": t("self_attn.q_proj.weight"),
        "wk": t("self_attn.k_proj.weight"),
        "wv": t("self_attn.v_proj.weight"),
        "wo": t("self_attn.o_proj.weight"),
        "ln2": tensors["post_attention_layernorm.weight"],
        "gate": t("block_sparse_moe.gate.weight"),
        "w1": experts("w1"),
        "w2": experts("w2"),
        "w3": experts("w3"),
    }


def block_param_shapes(cfg: MixtralBlockConfig, dtype=torch.bfloat16) -> dict:
    """The block's parameters as meta tensors (shape and dtype, no storage)."""
    h, hq, hkv, d, m, E = (cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads,
                           cfg.head_dim, cfg.intermediate_size, cfg.num_local_experts)
    shapes = {
        "ln1": (h,), "wq": (h, hq * d), "wk": (h, hkv * d), "wv": (h, hkv * d), "wo": (hq * d, h),
        "ln2": (h,), "gate": (h, E), "w1": (E, h, m), "w2": (E, m, h), "w3": (E, h, m),
    }
    return {name: torch.empty(shape, dtype=dtype, device="meta") for name, shape in shapes.items()}


FAMILY = register_family(
    ModelFamily(
        name="mixtral",
        block_arch="mixtral",
        config_from_hf=MixtralBlockConfig.from_hf_config,
        block_apply=block_apply,
        hf_block_prefixes=_HF_BLOCK_PREFIXES,
        hf_to_block_params=hf_to_block_params,
        block_param_shapes=block_param_shapes,
        supports_ring_attention=True,
    )
)
