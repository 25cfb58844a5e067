"""Ring attention: causal attention over a sequence split across sp ranks
(the port of petals_tpu/ops/ring_attention.py).

Each rank holds one block of query rows and the K/V rows of the same
positions. The K/V blocks go round the ring: at step i rank r holds the
block that started i ranks behind it, folds it into a float32 online
softmax over its own queries, and hands it to rank r + 1 (``Tensor.to`` its
device: a copy between cards, nothing where two ranks share one; it is
differentiable, so autograd carries the gradient back round the ring).
Causality, ALiBi and a sliding window are taken on GLOBAL positions, so
every family's attention can ride the ring. The JAX package's ring is plain
jnp, no Pallas kernel, and so is this one. ``FOLDS`` counts the blocks
folded (a ring of n ranks folds n * n per call).

Across processes (parallel/multihost.py) each process holds a run of
consecutive ranks: a rotation moves blocks within the run, and its last
rank's block to the next process's first rank (``collectives.ring_pass``,
send and receive at once; its backward goes round the other way). Each
process folds its own ranks' n blocks a rank, so the ``FOLDS`` of all the
processes sum to n * n a call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
FOLDS = [0]  # K/V blocks folded since the last reset


def fold_count() -> int:
    return FOLDS[0]


def reset_fold_count() -> None:
    FOLDS[0] = 0


def ring_attend(
    q: Sequence[torch.Tensor],  # one [b, rows, hq, d] query block a rank, in rank order
    k: Sequence[torch.Tensor],  # one [b, rows, hkv, d] K block a rank
    v: Sequence[torch.Tensor],
    *,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # [hq] BLOOM-style slopes of these heads
    sliding_window: Optional[int] = None,  # on global positions
    layout=None,  # a GroupLayout: the ranks given are this process's [s0, s0 + n_s) of its sp
) -> List[torch.Tensor]:
    """Causal attention of every rank's queries over the whole sequence;
    returns one [b, rows, hq, d] output a rank, on its queries' device, in
    their dtype. Rank r's rows sit at global positions [r * rows, (r + 1) *
    rows)."""
    n, first = (len(q), 0) if layout is None else (layout.sp, layout.s0)
    batch, rows, hq, d = q[0].shape
    hkv = k[0].shape[2]
    group = hq // hkv
    if scale is None:
        scale = d**-0.5
    state = []
    for qr in q:
        dev = qr.device
        state.append((
            torch.full((batch, hq, rows), NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((batch, hq, rows), dtype=torch.float32, device=dev),
            torch.zeros((batch, hq, rows, d), dtype=torch.float32, device=dev),
        ))
    blocks = list(zip(k, v))
    local = len(q)
    for i in range(n):
        for j in range(local):
            r = first + j
            state[j] = _fold(q[j].float(), blocks[j], state[j], r, (r - i) % n, rows, scale, group,
                             alibi_slopes, sliding_window)
        if i < n - 1:  # rotate: each rank receives the previous rank's block
            if layout is None:
                blocks = [tuple(t.to(q[r].device) for t in blocks[(r - 1) % n]) for r in range(n)]
            else:
                from petals_tpu_torch.parallel.collectives import ring_pass

                incoming = tuple(ring_pass(t, layout).to(q[0].device) for t in blocks[-1])
                blocks = [incoming] + [tuple(t.to(q[j].device) for t in blocks[j - 1]) for j in range(1, local)]
    return [(acc / l.clamp_min(1e-30)[..., None]).transpose(1, 2).to(qr.dtype)
            for (_, l, acc), qr in zip(state, q)]


def _fold(qf, kv_block, carry, my_rank: int, source_rank: int, rows: int, scale: float, group: int,
          alibi_slopes, sliding_window):
    """One visiting K/V block folded into a rank's online softmax
    (ring_attention.py ``fold``)."""
    FOLDS[0] += 1
    m_prev, l_prev, acc = carry
    k_blk, v_blk = kv_block
    batch, _, hq, d = qf.shape
    hkv = k_blk.shape[2]
    dev = qf.device
    q_pos = my_rank * rows + torch.arange(rows, dtype=torch.int32, device=dev)
    kv_pos = source_rank * rows + torch.arange(rows, dtype=torch.int32, device=dev)
    qg = qf.reshape(batch, rows, hkv, group, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k_blk.float()) * scale
    logits = logits.reshape(batch, hq, rows, rows)
    if alibi_slopes is not None:
        # a function of the absolute kv position only, unscaled (BLOOM)
        bias = alibi_slopes.to(dev).float()[:, None, None] * kv_pos.float()[None, None, :]
        logits = logits + bias[None]
    mask = kv_pos[None, :] <= q_pos[:, None]  # causal over GLOBAL positions
    if sliding_window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - sliding_window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    m_new = torch.maximum(m_prev, logits.amax(dim=-1))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(logits - m_new[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    l_new = alpha * l_prev + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.reshape(batch, hkv, group, rows, rows), v_blk.float())
    return m_new, l_new, acc * alpha[..., None] + pv.reshape(batch, hq, rows, d)


def ring_attention_sharded(
    q: torch.Tensor,  # [b, seq, hq, d], whole
    k: torch.Tensor,  # [b, seq, hkv, d]
    v: torch.Tensor,
    devices: Sequence,
    num_sp: int,
    *,
    alibi_slopes: Optional[torch.Tensor] = None,  # [hq]
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The ring over a tp x sp grid (``devices`` in ``serving_devices``'
    order): the sequence split over the ``num_sp`` ranks, the heads (and
    ALiBi slopes) over the tp shards, one ring a shard (the math is per
    head, so tp and sp compose with nothing more). ``seq`` must divide over
    the ranks. Returns the whole [b, seq, hq, d] output on ``q``'s device."""
    devices = [torch.device(d) for d in devices]
    n_tp = len(devices) // num_sp
    hq, hkv = q.shape[2] // n_tp, k.shape[2] // n_tp
    if q.shape[1] % num_sp:
        raise ValueError(f"ring attention needs the sequence ({q.shape[1]}) to divide over {num_sp} sp ranks")
    rows = q.shape[1] // num_sp
    outs = []
    for t in range(n_tp):
        devs = devices[t * num_sp : (t + 1) * num_sp]

        def parts(x, h):
            return [x[:, r * rows : (r + 1) * rows, t * h : (t + 1) * h].to(devs[r]) for r in range(num_sp)]

        slopes = None if alibi_slopes is None else alibi_slopes[t * hq : (t + 1) * hq]
        ranks = ring_attend(parts(q, hq), parts(k, hkv), parts(v, hkv), alibi_slopes=slopes,
                            sliding_window=sliding_window)
        outs.append(torch.cat([o.to(q.device) for o in ranks], dim=1))
    return torch.cat(outs, dim=2)
