"""The client's view of who serves which blocks
(petals_tpu/client/routing/sequence_info.py)."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Tuple

from petals_tpu_torch.data_structures import ModuleUID, RemoteModuleInfo, RemoteSpanInfo, ServerState
from petals_tpu_torch.utils.dht_utils import compute_spans
from petals_tpu_torch.utils.version import incompatibility_error, is_compatible

logger = logging.getLogger(__name__)

# (peer, version) pairs already warned about: a stale server would otherwise
# log on every routing refresh
_warned_incompatible: set = set()


@dataclasses.dataclass
class RemoteSequenceInfo:
    block_uids: Tuple[ModuleUID, ...]
    block_infos: List[Optional[RemoteModuleInfo]]
    spans_by_priority: List[RemoteSpanInfo]  # longest (then fastest) spans first
    spans_containing_block: Tuple[List[RemoteSpanInfo], ...]
    last_updated_time: Optional[float]

    @classmethod
    def make_empty(cls, block_uids: Sequence[ModuleUID]) -> "RemoteSequenceInfo":
        block_uids = tuple(block_uids)
        empty = tuple([] for _ in block_uids)
        return cls(block_uids, [None] * len(block_uids), [], empty, None)

    def __len__(self) -> int:
        return len(self.block_uids)

    def update_(self, new_block_infos: List[Optional[RemoteModuleInfo]]) -> None:
        assert len(new_block_infos) == len(self.block_uids)
        self.block_infos = list(new_block_infos)
        self.spans_by_priority, self.spans_containing_block = self._compute_spans(self.block_infos)
        self.last_updated_time = time.monotonic()

    @staticmethod
    def _compute_spans(block_infos):
        spans = list(compute_spans(block_infos, min_state=ServerState.ONLINE).values())
        usable = []
        for span in spans:
            # version gate at routing time: an incompatible server would fail
            # mid-step with an opaque wire error, so exclude it up front
            version = getattr(span.server_info, "version", None)
            if not is_compatible(version):
                key = (str(span.peer_id), version)
                if key not in _warned_incompatible:
                    _warned_incompatible.add(key)
                    logger.warning(f"Ignoring server {str(span.peer_id)[:16]}…: " + incompatibility_error(version))
                continue
            usable.append(span)
        spans_by_priority = sorted(usable, key=lambda s: (s.length, s.throughput), reverse=True)
        spans_containing_block = tuple([] for _ in block_infos)
        for span in usable:
            for block_idx in range(span.start, span.end):
                spans_containing_block[block_idx].append(span)
        return spans_by_priority, spans_containing_block
