"""Which span a joining server should host (the port's copy of the placement
half of petals_tpu/server/block_selection.py, in numpy): the span over the
swarm's weakest blocks. The rebalance check (``should_choose_other_blocks``)
waits with the rebalance loop."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from petals_tpu_torch.data_structures import PeerID, RemoteModuleInfo, ServerState


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
