"""Which span a server should host (petals_tpu/server/block_selection.py,
in numpy): the span over the swarm's weakest blocks for a joining server,
and the rebalance check (``should_choose_other_blocks``) that a serving one
runs every ``mean_balance_check_period``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from petals_tpu_torch.data_structures import PeerID, RemoteModuleInfo, ServerState

BALANCE_QUALITY = 0.75  # rebalance iff actual/optimal throughput drops below this


def compute_throughputs(
    module_infos: Sequence[Optional[RemoteModuleInfo]], *, exclude_peer: Optional[PeerID] = None
) -> np.ndarray:
    """Per-block total throughput of the swarm; JOINING servers count, as
    they will arrive soon."""
    throughputs = np.zeros(len(module_infos))
    for block_idx, info in enumerate(module_infos):
        if info is None:
            continue
        for peer_id, server in info.servers.items():
            if peer_id != exclude_peer and server.state.value >= ServerState.JOINING.value:
                throughputs[block_idx] += server.throughput
    return throughputs


def choose_best_start(throughputs: np.ndarray, num_blocks: int) -> int:
    """The start of the span with the lowest bottleneck; ties go to the span
    that is weakest overall, then to the leftmost."""
    options = [
        (throughputs[i : i + num_blocks].min(), throughputs[i : i + num_blocks].sum(), i)
        for i in range(0, len(throughputs) - num_blocks + 1)
    ]
    return min(options)[2]


def should_choose_other_blocks(
    local_peer: PeerID,
    module_infos: Sequence[Optional[RemoteModuleInfo]],
    num_blocks: Optional[int] = None,
    *,
    balance_quality: float = BALANCE_QUALITY,
    rng: Optional[np.random.RandomState] = None,
) -> bool:
    """Would the swarm's bottleneck improve enough if this server moved?

    Simulates our own best move AND everyone else's greedy follow-up moves
    until no server wants to move — a
    single-move simulation systematically over-estimates the benefit and
    thrashes in swarms of 3+ servers, because the spot we vacate looks weak
    to whoever evaluates next.
    """
    if balance_quality > 1.0:
        return True  # debugging override: force a move on every check

    from petals_tpu_torch.utils.dht_utils import compute_spans

    spans = compute_spans(module_infos, min_state=ServerState.JOINING)
    if local_peer not in spans:
        return False
    local_span = spans[local_peer]
    if num_blocks is not None and (local_span.end - local_span.start) != num_blocks:
        # the DHT shows only a fragment of our span (expired/partial records):
        # a verdict computed on the fragment would justify moves the caller's
        # real num_blocks-sized reload never matches — wait for a clean view
        return False
    if (local_span.server_info.throughput or 0.0) <= 0:
        return False  # still measuring: moving a zero-throughput span changes nothing
    eps = 1e-3
    rng = rng or np.random

    total = len(module_infos)
    throughputs = np.zeros(total)
    sim: Dict[PeerID, list] = {}  # peer -> [start, length, throughput]
    for pid, span in spans.items():
        tp = span.server_info.throughput or 0.0
        sim[pid] = [span.start, span.end - span.start, tp]
        throughputs[span.start : span.end] += tp
    initial = throughputs.min()

    def best_move(pid) -> int:
        """Lift the span out (eps-biased so near-ties prefer staying put) and
        return its best start under the current simulated layout."""
        start, length, tp = sim[pid]
        throughputs[start : start + length] -= tp * (1 + eps)
        new_start = choose_best_start(throughputs, length)
        throughputs[start : start + length] += tp * eps
        return new_start

    def settle(pid, new_start) -> None:
        sim[pid][0] = new_start
        _, length, tp = sim[pid]
        throughputs[new_start : new_start + length] += tp

    # our own move first
    start, length, tp = sim[local_peer]
    without_us = throughputs.copy()
    without_us[start : start + length] -= tp
    if initial > eps and without_us.min() <= 0:
        return False  # moving would disconnect the swarm
    new_start = best_move(local_peer)
    if new_start == start:
        throughputs[start : start + length] += tp  # put ourselves back
        return False  # already in the best place
    settle(local_peer, new_start)

    # everyone else's greedy follow-ups, to convergence (bounded for safety)
    for _round in range(10 * max(len(sim), 1)):
        peers = list(sim)
        rng.shuffle(peers)
        moved = False
        for pid in peers:
            prev = sim[pid][0]
            target = best_move(pid)
            settle(pid, target)
            moved = moved or target != prev
        if not moved:
            break

    converged = throughputs.min()
    if converged < initial or converged < eps:
        return False
    actual_quality = initial / converged
    return actual_quality < balance_quality - eps
