"""Preemptive session scheduler: arbitration of the paged KV pool (the
port's copy of petals_tpu/server/scheduler.py).

Petals' public-swarm premise is bursty demand from many independent clients,
yet before this subsystem a full page pool ended a session hard: admission
and prepare_write parked the caller on a waiter and raised AllocationFailed
at timeout. The scheduler converts that central failure mode into a
scheduling decision, in two layers:

- **Admission** (acquire_lane): lane waiters are ordered by priority class
  (session-open "priority" hint: high/normal/low, default normal), ties
  broken by per-peer fair share — among equal-priority waiters the peer
  consuming the least is admitted first, so one chatty client cannot
  monopolize the pool — then FIFO. Fair share ranks by the resource
  ledger's dominant-resource share (``usage_fn``: rolling-window DRF over
  page-seconds / compute-seconds / tokens / swap bytes) when wired, which
  sees page and prefill hogging that a raw lane count is blind to; the
  lanes-held count remains the inner tie-break and the whole rank when no
  ledger is attached.

- **Preemption** (prepare_write / swap-in on pool exhaustion): instead of
  only waiting for a page to free, the batcher asks the scheduler for a
  victim — an IDLE resident lane of equal-or-lower priority, lowest priority
  class first, least-recently-stepped within a class ("lru" policy; "largest"
  prefers the lane holding the most pages; "off" disables preemption). The
  victim's pages are gathered on device, copied to the host-RAM swap tier
  (memory_cache.HostSwapPool budget), and freed — waking the waiters. When
  the victim's session next steps, the batcher transparently swaps it back
  in onto whatever pages are then free (block tables make relocation free),
  so oversubscribed sessions stall briefly instead of dying.

This module holds POLICY and accounting only (victim ordering, fair share,
swap-entry bookkeeping, stats); the MECHANICS — device gather/scatter, table
mutation, page refcounts, the suspend/resume locking — live in
server/batching.py, which owns those structures. The dense lane pool keeps
priority/fair-share ADMISSION but never preempts: it has no relocatable
pages to swap, so its exhaustion stays on the waiter backpressure path.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from petals_tpu_torch.data_structures import SESSION_PRIORITY_NORMAL

logger = logging.getLogger(__name__)

PREEMPTION_POLICIES = ("lru", "largest", "off")


@dataclasses.dataclass
class SwapEntry:
    """One suspended lane's KV, resident in host RAM.

    ``k``/``v`` are [n_blocks, n_slots, page_size, hkv, d] host tensors
    holding exactly the pages that were resident at suspend time — or, for
    a quantized pool (``kv_quant_type != none``), ``PagedPool`` pairs of
    host tensors holding the PACKED codes + scales, so the swap tier stores
    wire bytes and the round trip back to the device is byte-exact.
    ``slots`` records WHICH table slots they back, so swap-in can restore
    the row onto fresh physical pages. ``generation`` pins the entry to the
    pool generation it was taken under — a pool reset invalidates it."""

    k: "torch.Tensor | object"  # host pages, or a PagedPool of host tensors
    v: "np.ndarray | object"
    slots: np.ndarray  # [n_slots] int32 table-slot indices
    nbytes: int  # WIRE bytes reserved in the HostSwapPool
    generation: int
    suspended_at: float = 0.0  # time.monotonic() at swap-out commit


@dataclasses.dataclass
class SessionSlot:
    """Scheduler-side state of one admitted lane."""

    lane: int
    peer_id: Optional[str]
    priority: int  # SESSION_PRIORITY_*: lower value = more important
    # the session's trace id: the flush loop and the compute thread cannot
    # see the request's context, so the slot carries it
    trace_id: Optional[str] = None
    last_step: int = 0  # scheduler clock tick of the most recent step
    swap: Optional[SwapEntry] = None  # non-None while suspended
    suspending: bool = False  # swap-out in flight (device gather queued)
    resumed_at: float = 0.0  # time.monotonic() of the last swap-in

    @property
    def suspended(self) -> bool:
        return self.swap is not None


class SessionScheduler:
    """Priority + fair-share arbitration of lanes and pages across sessions."""

    def __init__(
        self,
        swap_pool,  # memory_cache.HostSwapPool
        *,
        policy: str = "lru",
        pages_fn: Optional[Callable[[int], int]] = None,
        resume_quantum_s: float = 0.5,
        usage_fn: Optional[Callable[[Optional[str]], float]] = None,
    ):
        if policy not in PREEMPTION_POLICIES:
            raise ValueError(
                f"preemption_policy must be one of {PREEMPTION_POLICIES}, got {policy!r}"
            )
        self.swap_pool = swap_pool
        self.policy = policy
        # minimum residency after a resume (an OS timeslice, in effect):
        # without it, a just-swapped-in lane is re-victimized in the sliver
        # between its next two steps and the pool degenerates into swap
        # ping-pong — measured 5x more preemptions than burst boundaries
        # warrant under an oversubscribed interactive load
        self.resume_quantum_s = resume_quantum_s
        # resident page count of a lane ("largest" victim ordering + fair-share
        # page accounting); the batcher wires its block tables in, unit tests
        # wire a dict — the scheduler never reaches into batcher internals
        self.pages_fn = pages_fn or (lambda lane: 0)
        # peer -> dominant-resource share in [0, 1] (telemetry.ledger
        # peer_dominant_share); None keeps the raw lanes-held fair share.
        # Shares are quantized to avoid float jitter flapping the order.
        self.usage_fn = usage_fn
        self.lanes: Dict[int, SessionSlot] = {}
        self._clock = 0
        # every key pre-initialized: rpc_info spreads this dict, and the
        # schema must not depend on which paths have run
        self.stats = {
            "preemptions": 0,
            "swap_outs": 0,
            "swap_ins": 0,
            "swap_aborted": 0,
            "swap_dropped_on_reset": 0,
        }

    # ------------------------------------------------------------- lifecycle

    def register(
        self,
        lane: int,
        peer_id: Optional[str],
        priority: int,
        trace_id: Optional[str] = None,
    ) -> SessionSlot:
        self._clock += 1
        slot = SessionSlot(
            lane=lane, peer_id=peer_id, priority=int(priority),
            trace_id=trace_id, last_step=self._clock,
        )
        self.lanes[lane] = slot
        return slot

    def trace_id_of(self, lane: int) -> Optional[str]:
        slot = self.lanes.get(lane)
        return slot.trace_id if slot is not None else None

    def unregister(self, lane: int) -> None:
        slot = self.lanes.pop(lane, None)
        if slot is not None and slot.swap is not None:
            self.swap_pool.free(slot.swap.nbytes)
            # swarmlint: disable=lane-typestate — the slot is already popped from lanes: unreachable to new transitions, and a swap-out racing this release aborts on its post-gather re-registration check
            slot.swap = None

    def touch(self, lane: int) -> None:
        slot = self.lanes.get(lane)
        if slot is not None:
            self._clock += 1
            slot.last_step = self._clock

    def reset(self) -> None:
        """Pool reset: every swap entry's content targets a dead generation —
        drop them (freeing swap bytes) so suspended sessions fail loudly
        through the normal lane-generation check instead of scattering stale
        KV into the rebuilt pool."""
        for slot in self.lanes.values():
            # swarmlint: disable=lane-typestate — pool-wide reset: callers (the batcher's close, a failed step's reset) invalidate every lane wholesale; racing swap paths fail on the generation check, and per-lane locking here would deadlock against them
            slot.suspending = False
            if slot.swap is not None:
                self.swap_pool.free(slot.swap.nbytes)
                # swarmlint: disable=lane-typestate — same pool-wide reset as the suspending flag above: dead-generation entries are dropped wholesale
                slot.swap = None
                self.stats["swap_dropped_on_reset"] += 1

    # ------------------------------------------------------------ admission

    def peer_lanes_held(self, peer_id: Optional[str]) -> int:
        return sum(1 for s in self.lanes.values() if s.peer_id == peer_id)

    def peer_pages_held(self, peer_id: Optional[str]) -> int:
        return sum(
            self.pages_fn(s.lane) for s in self.lanes.values() if s.peer_id == peer_id
        )

    def peer_usage_share(self, peer_id: Optional[str]) -> float:
        """Quantized dominant-resource share of ``peer_id`` (0.0 without a
        ledger — every rank below then degrades to the pre-ledger order)."""
        if self.usage_fn is None:
            return 0.0
        try:
            return round(float(self.usage_fn(peer_id)), 3)
        except Exception as e:
            # an accounting bug must degrade ranking, never block admission
            logger.warning(f"usage_fn failed for {peer_id!r}: {e}")
            return 0.0

    def pick_waiter(self, waiters: Sequence) -> Optional[object]:
        """Admission order for lane waiters: highest priority class first,
        then the peer with the smallest dominant-resource share (DRF fair
        share via the ledger; 0 for everyone without one), then the peer
        holding the fewest lanes, then FIFO. ``waiters`` entries expose
        .priority, .peer_id, .seq (batching.py _LaneWaiter); returns the
        entry to admit, or None when empty."""
        live = [w for w in waiters if not w.fut.done()]
        if not live:
            return None
        return min(
            live,
            key=lambda w: (
                w.priority,
                self.peer_usage_share(w.peer_id),
                self.peer_lanes_held(w.peer_id),
                w.seq,
            ),
        )

    # ------------------------------------------------------------ preemption

    def pick_victim(
        self, candidates: Iterable[int], *, max_priority: Optional[int] = None
    ) -> Optional[int]:
        """Choose the lane to preempt among ``candidates`` (already filtered
        by the batcher for idleness and residency). Victims must be of equal
        or LOWER importance than the requester (priority value >=
        ``max_priority``); ordering is lowest priority class first, then the
        owning peer's dominant-resource share (the ledger's DRF view: a
        noisy peer's lanes go first, 0 for everyone without a ledger), then
        least-recently-stepped ("lru") or most pages held ("largest")."""
        if self.policy == "off":
            return None
        now = time.monotonic()
        best, best_key = None, None
        for lane in candidates:
            slot = self.lanes.get(lane)
            if slot is None or slot.suspending or slot.swap is not None:
                continue
            if max_priority is not None and slot.priority < max_priority:
                continue  # never preempt a more important session
            if now - slot.resumed_at < self.resume_quantum_s:
                continue  # just resumed: let it run its quantum (anti-thrash)
            share = self.peer_usage_share(slot.peer_id)
            if self.policy == "largest":
                key = (-slot.priority, -share, -self.pages_fn(lane), slot.last_step)
            else:  # lru
                key = (-slot.priority, -share, slot.last_step, -self.pages_fn(lane))
            if best_key is None or key < best_key:
                best, best_key = lane, key
        return best

    # --------------------------------------------------------- observability

    @property
    def suspended_count(self) -> int:
        return sum(1 for s in self.lanes.values() if s.swap is not None)

    def oldest_swap_age(self, now: Optional[float] = None) -> float:
        """Seconds the longest-suspended session has been resident in the
        host swap tier (0.0 when nothing is suspended) — the residency-age
        half of the swap-tier economics: a large age under load means a
        session is starving, not merely preempted."""
        if now is None:
            now = time.monotonic()
        ages = [
            now - s.swap.suspended_at
            for s in self.lanes.values()
            if s.swap is not None and s.swap.suspended_at > 0
        ]
        return max(ages, default=0.0)

    def summary(self) -> dict:
        # the ONE swap budget splits two ways: suspended sessions and the
        # radix prefix cache's demoted nodes (kind="cache" reservations)
        cache_bytes = getattr(self.swap_pool, "cache_bytes_in_use", 0)
        return {
            "policy": self.policy,
            "suspended": self.suspended_count,
            "swap_oldest_s": round(self.oldest_swap_age(), 1),
            "swap_bytes_in_use": self.swap_pool.bytes_in_use,
            "swap_session_bytes": self.swap_pool.bytes_in_use - cache_bytes,
            "swap_cache_bytes": cache_bytes,
            "swap_bytes_total": self.swap_pool.max_size_bytes,
            "swap_peak_bytes": self.swap_pool.stats["peak_bytes"],
            "swap_rejected": self.swap_pool.stats["rejected"],
            "swap_cache_rejected": self.swap_pool.stats.get("cache_rejected", 0),
            **self.stats,
        }


__all__ = [
    "PREEMPTION_POLICIES",
    "SESSION_PRIORITY_NORMAL",
    "SessionScheduler",
    "SessionSlot",
    "SwapEntry",
]
