"""Continuous batching over a shared KV pool: coalesce concurrent sessions'
decode tokens, and one prefill chunk, into one step per tick
(petals_tpu/server/batching.py, paged and dense modes).

- One shared page pool [n_blocks, n_pages, page_size, hkv, d] x2, budgeted
  through MemoryCache once at open (a quantized pool is 4 buffers, codes and
  scales of each side, budgeted by their stored bytes). Each session
  borrows a LANE for its lifetime and addresses the pool through its
  block-table row; lanes grow page by page (``prepare_write``), so
  admission costs one page.
- Every step runs over all lanes. Idle lanes ride at the sentinel position
  ``max_length``: their KV writes drop and their outputs are never read.
- A prefill is admitted with its whole page range allocated, then fed one
  page-aligned chunk per tick alongside the pending decode lanes (the mixed
  step), round-robin across admitted prefills under a per-tick token budget.
- Server-side generation (a batcher holding the client's leaves,
  ``gen_params``): ``generate_lane`` registers a lane that generates a
  chunk of tokens; every tick advances each generating lane by one token
  and every pending decode lane in ONE generation step (the backend's
  ``paged_gen_decode_step``), and a waiting prefill chunk rides its own
  mixed step in the same tick.
- Speculative decoding (a batcher holding a ``DraftModel``,
  server/spec_decode.py, beside the client's leaves, on the paged pool):
  each tick the eligible generating lanes (``_pick_spec_lanes``: room for
  k + 1 rows, no cooldown) leave the generation step for a spec step of
  their own (``_run_batch_spec``): the draft proposes k tokens a lane from
  the lane's context and collected tokens, and ONE verify step
  (``paged_spec_verify_step``) writes and attends k + 1 rows a lane and
  samples the target's token on each, with row j's uniform that of the
  stream's next draw plus j. The event loop commits each lane's leading
  matches plus one (``_commit_spec_results``): the stream is plain
  decode's, token for token. Rollback is position truncation: no page is
  freed, no refcount touched. A lane whose acceptance EMA falls below
  ``PETALS_TPU_SPEC_MIN_ACCEPT`` stops speculating for
  ``PETALS_TPU_SPEC_COOLDOWN`` ticks. The verify rows spend the tick's
  prefill budget as chunk rows do.

- Dense mode (``page_size`` None or 0, and always over a tensor-parallel
  backend, whose pool is a ShardedCache pair): the pool is [n_blocks,
  n_lanes, max_length, hkv, d] x2 and a lane is its row. Decode steps coalesce the
  same way (``batched_decode_step``); work the batched step does not cover
  (a prefill, deep prompts, hypo_ids) runs on the lane's session-shaped
  VIEW of the pool (``dense_lane_view``, written in place) as queue tasks of
  its own (``run_exclusive``, ``run_exclusive_chunks``). Batched steps
  interleave between a long prefill's chunks: the lane rides them at the
  sentinel, so they neither write nor read it. The paged pool serves the
  same exclusive ops through a gather of the lane's pages into a fresh
  session-shaped copy, checked OUT, and a scatter back IN.

Steps run on the task queue's compute thread and mutate the pool IN PLACE.
On a CUDA card every step replays the backend's step programs (CUDA graphs
keyed by the pool's address, server/backend.py): the pool never moves, so
they are all captured when it opens, and serving only replays them. A paged
pool warms the decode step and the mixed step at every chunk bucket up to
``max_chunk`` (``warm_step_programs``); a dense pool the batched decode step
and, on every lane's view, the plain chunk at every bucket up to the
backend's ``longest_chunk`` (``warm_dense_programs``); both the generation
step when the batcher generates. ``stats`` carries the captures, replays
and late captures (``graph_*``); a lane's exclusive op with deep prompts or
hypo_ids replays a private step program, captured on its key's second call.
A step that fails with a device error leaves the pool untrustworthy: the pool
is zeroed and the generation bumps, so every outstanding lane fails loudly on
its next step instead of decoding against lost KV. The generation is checked
before each step and again, under the reset lock, after it.

Prefix-cache pages (petals_tpu/server/batching.py): a page's refcount
counts its table slots and its prefix-cache pins. ``pin_lane_pages`` takes
a pin on a lane's pages for the cache, ``adopt_pages`` points a lane's first
slots at pinned pages (a hit that copies nothing), and ``prepare_write``
forks a shared page (``refs > 1``) before any write: a fresh page, the
shared one copied into it on the compute thread (``backend.copy_page``, in
place), then the shared reference dropped. A pool reset bumps
``page_epoch``, so pins taken on the dead pool unpin as no-ops.
``snapshot_lane`` copies a lane's rows out for the cache's store.

The session scheduler (server/scheduler.py; petals_tpu/server/batching.py's
scheduler and swap paths): lane waiters are admitted by priority class, then
the peer's dominant-resource share in the resource ledger, then the lanes
that peer holds, then FIFO (``pick_waiter``). With ``swap_host_bytes > 0``
on the paged pool, a ``prepare_write`` (or a swap-in) that finds no free
page first PREEMPTS an idle victim lane (``pick_victim``: lowest priority,
then the dominant peer, then the least recently stepped, or the largest):
its pages are copied to host memory on the compute thread
(``backend.swap_out_pages``), its table row cleared and its pages freed.
The lane's next operation swaps it back in first (``_lane_busy`` ->
``_ensure_resident``): fresh pages, all at once and one resumer at a time
(the turnstile), written in place (``backend.swap_in_pages``) and the row
rewritten on the compute thread between steps, so the next replay reads
the moved pages. A lane is a victim only while nothing touches it: no step
pending or in flight, no prefill or generation stream, no exclusive op, no
swap under way. The dense pool never preempts. Locks come from
analysis/sanitizer.py, so ``PETALS_TPU_SANITIZE=1`` checks their order.

The resource ledger (telemetry/ledger.py): each admitted lane is a ledger
session; page-seconds (shared pages split by refcount), lane-seconds,
compute-seconds (each step's wall split over its lanes), tokens and swap
bytes accrue to it, and each pooled reply carries the delta since the last
(``pop_usage_delta``) beside the two-field load hint (``occupancy_hint``).

Telemetry (telemetry/), recorded where petals_tpu's batcher records, on
the host after each step's outputs reached it (never inside a captured
step): each batched step's wall and count by variant (``dense``,
``paged``, ``mixed``, ``gen``, ``spec``) and its decode tokens, the
prefill queue wait, the pool gauges at every occupancy boundary, swap
bytes, preemptions and allocation failures; the journal's ``admission``,
``waiter_picked``, ``victim_selected``, ``swap_out``, ``swap_in``,
``noisy_neighbor`` and ``spec_disabled`` events, each with the occupancy
that justified it. With fingerprints enabled the step programs return the
fused digest of each lane's last row (server/backend.py ``pop_step_fp``),
which ``_capture_step_fp`` stashes per lane for the handler's reply
(``pop_step_fp``); a mixed step's chunk lane takes its chunk's digest.

Multi-host lockstep (parallel/multihost.py; a ``LockstepBackend``): the
pool is the dense one, mirrored on every worker by handle; the batched
decode step broadcasts. Work the batched step does not cover checks a lane
out under a synthetic negative handle minted here (``_new_temp``; the
backend's ``lane_extract`` registers every process's view of the lane under
it) and back in (``lane_insert``); a check-out that is not inserted back (a
failed op, a read-only snapshot) is released (``_release_temp``), and
``snapshot_lane`` reads a lane through the group's export. A failed step
under lockstep degrades the group rather than resetting the pool: the
workers' mirrors would desync.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import itertools
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from petals_tpu_torch.analysis.sanitizer import lock_try_acquire_nowait, make_async_lock, make_thread_lock
from petals_tpu_torch.data_structures import SESSION_PRIORITY_NORMAL
from petals_tpu_torch.ops.paged_attention import PagedPool, dequantize_kv_np, max_pages_for
from petals_tpu_torch.ops.sampling import sampling_vectors
from petals_tpu_torch.ops.threefry import uniform_for_draw
from petals_tpu_torch.server.memory_cache import AllocationFailed, HostSwapPool, MemoryCache, PageAllocator
from petals_tpu_torch.server.scheduler import SessionScheduler, SwapEntry
from petals_tpu_torch.server.spec_decode import min_accept_floor
from petals_tpu_torch.server.task_queue import PRIORITY_INFERENCE, PriorityTaskQueue
from petals_tpu_torch.telemetry import instruments as tm
from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.ledger import derive_efficiency, get_ledger
from petals_tpu_torch.utils.asyncio_utils import shield_and_wait
from petals_tpu_torch.utils.locks import AsyncTryLock

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _LanePrefillState:
    """One lane's admitted prefill: the flush loop feeds one chunk per mixed
    step until ``offset`` reaches the full length, then resolves ``future``
    with the concatenated span outputs."""

    future: asyncio.Future
    generation: int
    lane: int
    hidden: torch.Tensor  # [1, total, hidden] on the host, float32
    position: int  # absolute position of the next unfed token
    offset: int  # tokens already fed
    cap: int  # per-step chunk cap (chunk_plan byte sizing)
    outs: List[torch.Tensor]
    # the lane's length once the prefill is in (longrope's factor choice);
    # None: each chunk's own end
    n_total: Optional[int] = None
    enqueued: float = 0.0  # time.perf_counter() at admission
    queue_s: float = 0.0  # admission -> first chunk
    compute_s: float = 0.0  # summed mixed-step wall across chunks


@dataclasses.dataclass
class _LaneGenState:
    """One lane mid server-side generation: each tick's generation step
    feeds ``token`` at ``position`` and samples the next, until
    ``remaining`` reaches 0; then ``future`` resolves with ``collected``
    (petals_tpu/server/batching.py ``_LaneGenState``)."""

    future: asyncio.Future
    generation: int
    token: int  # the last sampled token: fed on the next step
    position: int  # where that step writes it
    remaining: int  # steps left (n_tokens - 1 at the start)
    collected: List[int]
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    seen: Optional[np.ndarray] = None  # [vocab] bool; only under a penalty
    # the uniforms of the stream's draws after the first, one a step (the
    # Threefry draws offset + 1, offset + 2, ...); only when sampling
    uniforms: Optional[np.ndarray] = None
    enqueued: float = 0.0  # time.perf_counter() at registration
    started: bool = False  # the first step has recorded the queue wait
    queue_s: float = 0.0
    compute_s: float = 0.0  # summed generation-step wall
    # speculative decoding: the client's context (the draft's window reads
    # it before the collected tokens), the acceptance-rate EMA behind the
    # auto-disable, the plain ticks left of a cooldown, and the stream's
    # proposed / accepted draft counts for its step_meta
    context: Optional[List[int]] = None
    spec_ema: float = 1.0  # optimistic start: a new lane gets to speculate
    spec_cooldown: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0


@dataclasses.dataclass
class _LaneWaiter:
    """One parked acquire_lane caller. The scheduler's ``pick_waiter``
    admits by priority class, then the peer's fair share, then ``seq``."""

    fut: asyncio.Future
    priority: int
    peer_id: Optional[str]
    seq: int
    trace_id: Optional[str] = None


class DecodeBatcher:
    """Shared-pool continuous batcher for one backend (one span)."""

    def __init__(
        self,
        backend,
        memory_cache: MemoryCache,
        queue: PriorityTaskQueue,
        *,
        n_lanes: int = 8,
        max_length: int = 1024,
        page_size: Optional[int] = 64,  # None or 0: the dense lane pool
        n_pages: Optional[int] = None,  # default: n_lanes * max_pages (no oversubscription)
        prefill_token_budget: int = 512,  # max prefill-chunk tokens per mixed step
        alloc_timeout: Optional[float] = None,
        gen_params: Optional[dict] = None,  # the client's leaves: server-side generation
        swap_host_bytes: int = 0,  # host-memory swap tier of preempted lanes; 0: no preemption
        preemption_policy: str = "lru",  # victim choice on page exhaustion: lru | largest | off
        ledger=None,  # a ResourceLedger (telemetry/ledger.py); None: the process's
        draft_model=None,  # a DraftModel (server/spec_decode.py): speculative decoding
        spec_k: Optional[int] = None,  # drafts a lane a tick; None: the draft's k
    ):
        if page_size is not None and page_size < 0:
            raise ValueError(f"page_size must be >= 1, or 0 / None for the dense lane pool; got {page_size}")
        self.backend = backend
        self.memory_cache = memory_cache
        self.queue = queue
        self.n_lanes = n_lanes
        # a span over a mesh (tensor or sequence parallel) keeps the dense
        # lane pool, as petals_tpu's batcher gates paging off under a mesh
        if page_size and getattr(backend, "mesh_size", 1) == 1:
            self.page_size: Optional[int] = int(page_size)
            # round the lane capacity UP to whole pages so tables tile exactly
            self.max_pages = max_pages_for(max_length, self.page_size)
            self.max_length = self.max_pages * self.page_size
            self.n_pages = int(n_pages) if n_pages else self.n_lanes * self.max_pages
            if self.n_pages < self.max_pages:
                raise ValueError(
                    f"n_pages={self.n_pages} cannot hold even one full lane "
                    f"({self.max_pages} pages of {self.page_size} tokens)"
                )
        else:
            if getattr(backend, "kv_quant_type", "none") != "none":
                raise ValueError("a quantized KV pool needs the paged pool (page_size > 0)")
            self.page_size = None
            self.max_length = int(max_length)
            self.max_pages = 0
            self.n_pages = 0
        self.prefill_token_budget = max(int(prefill_token_budget), 1)
        self.alloc_timeout = alloc_timeout
        self.gen_params = gen_params
        self._gen_states: Dict[int, _LaneGenState] = {}
        # speculative decoding: k drafts a lane verified in one paged step a
        # tick; the verify step embeds and samples with the client's leaves
        self.draft = draft_model
        self.spec_k = int(spec_k if spec_k is not None else getattr(draft_model, "spec_k", 0) or 0)
        if draft_model is not None:
            draft_k = int(getattr(draft_model, "spec_k", self.spec_k))
            if self.spec_k != draft_k:
                raise ValueError(f"spec_k={self.spec_k} does not match the draft model's compiled k={draft_k}")
            if gen_params is None:
                raise ValueError(
                    "Speculative decoding needs the client leaves loaded "
                    "(gen_params): the verify step embeds and samples on device"
                )
        # the draft whose buckets are warmed (captured on a card): the first
        # spec tick warms it on the compute thread; a swapped-in draft re-warms
        self._draft_warmed = None
        self._spec_min_accept = min_accept_floor()
        self._spec_ema_alpha = 0.2
        try:
            self._spec_cooldown_ticks = max(int(os.environ.get("PETALS_TPU_SPEC_COOLDOWN", 64)), 1)
        except ValueError:
            self._spec_cooldown_ticks = 64
        self._pages: Optional[PageAllocator] = None
        self._tables: Optional[np.ndarray] = None  # [n_lanes, max_pages] int32, -1 = unallocated
        self._prefill_queue: List[_LanePrefillState] = []
        self._pool_stack: Optional[contextlib.AsyncExitStack] = None
        self._handles = None
        # bumped by a pool reset: every outstanding lane is invalidated
        self._generation = 0
        # multi-host lockstep: lane check-outs live on the workers under
        # synthetic NEGATIVE handles (never a MemoryCache handle)
        self._lockstep = bool(getattr(backend, "is_lockstep", False))
        self._temp_ids = itertools.count(-2, -1)
        # makes the compute thread's post-step generation check atomic with
        # respect to a reset (check-then-act alone is a race)
        self._reset_lock = make_thread_lock("batching._reset_lock")
        # bumped by a pool reset too: prefix-cache pins carry the epoch they
        # were taken under, so a stale pin never decrefs the rebuilt allocator
        self._page_epoch = 0
        self._lane_generation: Dict[int, int] = {}
        self._free_lanes: List[int] = []
        self._lane_waiters: List[_LaneWaiter] = []
        self._waiter_seq = itertools.count()
        self._pending: List[tuple] = []  # (lane, hidden, position, future, generation)
        # per-lane queue/compute split of the last finished step (step_meta);
        # one step in flight per lane, so the loop and the compute thread
        # never race on one key
        self._enq_t: Dict[int, float] = {}
        self._step_timing: Dict[int, dict] = {}
        # the finished step's fused fingerprint per lane (FP_DIM floats)
        self._step_fp: Dict[int, list] = {}
        # every scheduler decision goes to the journal with its occupancy
        self._journal = get_journal()
        self._flush_task: Optional[asyncio.Task] = None
        self._open_lock = make_async_lock("batching._open_lock")
        self._closed = False
        # the session scheduler: priority + fair-share admission, and (paged
        # pool, swap_host_bytes > 0) preemption of idle lanes to host memory
        self.swap_pool = HostSwapPool(int(swap_host_bytes or 0))
        if ledger is None:
            ledger = get_ledger()
        self._ledger = ledger
        ledger.set_kv_cost(backend.kv_quant_type, backend.kv_bytes_per_token())
        self._ledger_keys: Dict[int, str] = {}  # lane -> ledger session key
        self._scheduler = SessionScheduler(
            self.swap_pool, policy=preemption_policy, pages_fn=self._lane_pages,
            usage_fn=ledger.peer_dominant_share,
        )
        # per-lane locks serialize a swap-out against a swap-in; the in-flight
        # count makes a lane with any operation under way unpreemptable
        self._lane_locks: Dict[int, AsyncTryLock] = {}
        self._inflight: Dict[int, int] = {}
        # swap-ins take pages one resumer at a time: two resumers each holding
        # part of what they need would starve each other
        self._swap_in_turnstile = make_async_lock("batching._swap_in_turnstile")
        # the latest swaps, each {"dir", "lane", "pages", "bytes", "seconds"}
        # (the compute thread's copy time, measured around the synced copy)
        self.swap_events: collections.deque = collections.deque(maxlen=256)
        # graph_*: the backend's step programs (CUDA graphs on a card):
        # captures, replays, and captures after warm-up (anomalies)
        self.stats = {
            "batched_steps": 0, "batched_tokens": 0, "max_batch": 0,
            "gen_steps": 0, "gen_lane_tokens": 0, "max_gen_lanes": 0,
            "decode_steps": 0, "mixed_steps": 0, "prefill_tokens": 0,
            "max_prefill_tokens_per_step": 0, "pool_resets": 0, "exclusive_chunks": 0,
            "graph_captures": 0, "graph_replays": 0, "graph_anomalies": 0,
            "spec_steps": 0, "spec_proposed": 0, "spec_accepted": 0, "spec_disabled": 0, "max_spec_lanes": 0,
        }

    # ------------------------------------------------------------------ pool

    async def ensure_open(self, timeout: Optional[float] = None) -> None:
        """Reserve the pool on first use (budgeted through MemoryCache) and,
        on a card, capture its step programs. The pool is published only
        once they are warm: a warm-up that fails or is cancelled releases
        the pool, so the next call opens it and warms it again."""
        async with self._open_lock:
            if self._handles is not None or self._closed:
                return
            if self.page_size is not None:
                descs = self.backend.paged_cache_descriptors(
                    self.n_pages, self.page_size, 0, self.backend.n_blocks
                )
            else:
                descs = self.backend.cache_descriptors(
                    self.n_lanes, self.max_length, 0, self.backend.n_blocks
                )
            stack = contextlib.AsyncExitStack()
            try:
                handles = await stack.enter_async_context(
                    self.memory_cache.allocate_cache(
                        *descs, timeout=self.alloc_timeout if timeout is None else timeout
                    )
                )
            except BaseException:
                await stack.aclose()
                raise
            bufs = self.memory_cache.get_buffers(*handles)
            try:
                await self._warm_programs(self._pool_pair(bufs))
            except BaseException:
                # not published: drop what the warm-up captured (queued behind
                # it, so after it ends on the compute thread) and free the pool
                await shield_and_wait(self._release_unpublished(stack, bufs))
                raise
            self._pool_stack = stack
            self._handles = handles
            self._free_lanes = list(range(self.n_lanes))
            span = f"[{self.backend.first_block}, {self.backend.first_block + self.backend.n_blocks})"
            if self.page_size is None:
                logger.info(
                    f"Continuous-batching pool open: {self.n_lanes} lanes x "
                    f"{self.max_length} tokens for blocks {span}"
                )
                return
            self._pages = PageAllocator(self.n_pages)
            self._tables = np.full((self.n_lanes, self.max_pages), -1, np.int32)
            logger.info(
                f"Paged-batching pool open: {self.n_pages} pages x {self.page_size} tokens "
                f"({self.n_lanes} lanes x {self.max_pages} table slots) for blocks {span}"
            )

    async def _warm_programs(self, pool_kv) -> None:
        """On a card, capture every step program on the pool about to open,
        so that serving replays and captures nothing: the dense pool's
        batched steps and each lane view's chunks, or the paged pool's
        decode, generation, verify and mixed steps. A no-op on the CPU."""
        if self.backend.device.type != "cuda":
            return
        if self.page_size is None:
            await self.queue.submit(
                self.backend.warm_dense_programs, pool_kv, self.n_lanes, self.max_length,
                self.backend.longest_chunk(1), self.gen_params,
            )
        else:
            await self.queue.submit(
                self.backend.warm_step_programs, pool_kv, self.n_lanes, self.max_pages,
                self.max_chunk(), self.gen_params, self.spec_k if self.draft is not None else 0,
            )

    async def _release_unpublished(self, stack: contextlib.AsyncExitStack, bufs) -> None:
        await self.queue.submit(self.backend.drop_cache_programs, bufs)
        await stack.aclose()

    async def close(self) -> None:
        self._closed = True
        with self._reset_lock:
            # every lane's KV goes with the pool: a session's next step, or a
            # step still pending, fails loudly and its client repairs
            self._generation += 1
            if self._pages is not None:
                self._pages.freed_event.set()  # wake the page waiters
        for w in self._lane_waiters:
            if not w.fut.done():
                w.fut.set_exception(AllocationFailed("Batcher is shutting down"))
        self._lane_waiters.clear()
        self._scheduler.reset()  # drop the swap entries and their host bytes
        for st in self._gen_states.values():
            if not st.future.done():
                st.future.set_exception(AllocationFailed("Batcher is shutting down"))
        self._gen_states.clear()
        for pst in self._prefill_queue:
            if not pst.future.done():
                pst.future.set_exception(AllocationFailed("Batcher is shutting down"))
        self._prefill_queue.clear()
        if self._pool_stack is not None:
            # the step programs address the pool: they go with it
            self.backend.drop_cache_programs(self.memory_cache.get_buffers(*self._handles))
            await self._pool_stack.aclose()
            self._pool_stack = None
            self._handles = None

    def _buffers(self):
        """The (k_pool, v_pool) pair every step consumes and mutates."""
        return self._pool_pair(self.memory_cache.get_buffers(*self._handles))

    @staticmethod
    def _pool_pair(bufs):
        """A quantized pool rides as 4 buffers (codes x2, scales x2) and is
        wrapped back into a pair of PagedPools here."""
        if len(bufs) == 4:
            return PagedPool(bufs[0], bufs[2]), PagedPool(bufs[1], bufs[3])
        return tuple(bufs)

    def pool_info(self) -> dict:
        """The pool's encoding and its stored bytes per token (rpc_info)."""
        return {
            "kv_quant": self.backend.kv_quant_type,
            "kv_bytes_per_token": int(self.backend.kv_bytes_per_token()),
        }

    def paged_summary(self) -> Optional[dict]:
        """Pool occupancy and the allocator's counters (rpc_info), None on
        the dense pool."""
        if self.page_size is None:
            return None
        alloc = self._pages
        return {
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "page_epoch": self._page_epoch,
            "pages_free": alloc.n_free if alloc is not None else self.n_pages,
            **({f"pages_{k}": v for k, v in alloc.stats.items()} if alloc is not None else {}),
        }

    def occupancy_info(self) -> dict:
        """Lane, page and scheduler occupancy, as a petals_tpu server
        announces it in ServerInfo.pool and answers it in rpc_info, so
        clients can route around a loaded server: busy lanes, free pages and
        their fragmentation, suspended sessions, swap bytes, preemptions."""
        info = {
            "lanes": self.n_lanes,
            "busy_lanes": self._busy_lanes(),
            "lane_waiters": len(self._lane_waiters),
        }
        if self.page_size is not None:
            info["n_pages"] = self.n_pages
            info["pages_free"] = self._pages.n_free if self._pages is not None else self.n_pages
            if self._pages is not None:
                frag = self._pages.fragmentation_info()
                info["frag"] = frag["frag"]
                info["largest_free_run"] = frag["largest_run"]
            info.update(self.pool_info())
        info.update(self._scheduler.summary())
        return info

    def occupancy_hint(self) -> dict:
        """The two-field load hint riding every pooled reply's step_meta."""
        return {"busy_lanes": self._busy_lanes(), "lane_waiters": len(self._lane_waiters)}

    def _busy_lanes(self) -> int:
        return self.n_lanes - len(self._free_lanes) if self._handles is not None else 0

    # ------------------------------------------------------------------ lanes

    async def acquire_lane(
        self, timeout: Optional[float] = None, *, priority: int = SESSION_PRIORITY_NORMAL,
        peer_id: Optional[str] = None, trace_id: Optional[str] = None,
    ) -> int:
        """Borrow a lane; queues when all lanes are taken. Parked callers are
        admitted by priority class, then the peer's fair share, then FIFO
        (the scheduler's ``pick_waiter``). ``peer_id`` is whom the session
        bills to (the resource ledger). Admission also claims the lane's
        first page, preempting an idle lane when the swap tier is on.
        ``timeout`` bounds the whole acquisition, first-use pool allocation
        included."""
        t_wait = time.perf_counter()
        lane = await self._acquire_lane(timeout=timeout, priority=priority, peer_id=peer_id, trace_id=trace_id)
        self._scheduler.register(lane, peer_id, int(priority), trace_id=trace_id)
        # the ledger session opens before the first page, so every
        # page-second of the lane's residency lands on its bill
        self._ledger_keys[lane] = self._ledger.open_session(peer_id, trace_id)
        if self.page_size is not None:
            try:
                await self.prepare_write(lane, 0, 1, timeout=timeout)
            except BaseException:
                self.release_lane(lane)
                raise
        self._journal.event(
            "admission", trace_id=trace_id, lane=lane, occupancy=self.occupancy_info(), priority=int(priority),
            wait_s=round(time.perf_counter() - t_wait, 6),
        )
        self._note_occupancy()
        return lane

    async def _acquire_lane(self, timeout: Optional[float], priority: int, peer_id: Optional[str],
                            trace_id: Optional[str]) -> int:
        await self.ensure_open(timeout=timeout)
        if self._closed:
            raise AllocationFailed("Batcher is closed")
        if self._free_lanes:
            lane = self._free_lanes.pop(0)
            self._lane_generation[lane] = self._generation
            return lane
        waiter = _LaneWaiter(
            fut=asyncio.get_running_loop().create_future(),
            priority=int(priority), peer_id=peer_id, seq=next(self._waiter_seq), trace_id=trace_id,
        )
        fut = waiter.fut
        self._lane_waiters.append(waiter)
        try:
            lane = await asyncio.wait_for(fut, timeout)
            self._lane_generation[lane] = self._generation
            return lane
        except asyncio.TimeoutError:
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                lane = fut.result()  # resolved in the cancellation race window
                self._lane_generation[lane] = self._generation
                return lane
            tm.ALLOC_FAILED.inc()
            raise AllocationFailed(f"No free decode lane within {timeout} s ({self._occupancy()})")
        except BaseException:
            # cancelled after release_lane already handed us the lane: put it
            # back, or pool capacity shrinks forever
            if fut.done() and not fut.cancelled() and fut.exception() is None:
                self.release_lane(fut.result())
            raise
        finally:
            if waiter in self._lane_waiters:
                self._lane_waiters.remove(waiter)

    def release_lane(self, lane: int) -> None:
        self._enq_t.pop(lane, None)
        self._step_timing.pop(lane, None)
        self._step_fp.pop(lane, None)
        # a timed-out or cancelled session may have left a step queued: fail
        # it, or its stale KV write could land in the next tenant's history
        kept = []
        for entry in self._pending:
            if entry[0] == lane:
                if not entry[3].done():
                    entry[3].set_exception(AllocationFailed("Lane released mid-step"))
            else:
                kept.append(entry)
        self._pending = kept
        # likewise a generating lane: its stream must never resolve against
        # a lane now owned by someone else
        st = self._gen_states.pop(lane, None)
        if st is not None and not st.future.done():
            st.future.set_exception(AllocationFailed("Lane released mid-step"))
        for pst in [p for p in self._prefill_queue if p.lane == lane]:
            self._prefill_queue.remove(pst)
            if not pst.future.done():
                pst.future.set_exception(AllocationFailed("Lane released mid-step"))
        self._lane_generation.pop(lane, None)
        # a suspended lane's host bytes free with its slot, and a swap-out
        # racing this release aborts on its check after the gather
        self._scheduler.unregister(lane)
        key = self._ledger_keys.pop(lane, None)
        if key is not None:
            self._ledger.close_session(key)  # totals fold into the peer's rollup
        if self._tables is not None:
            row = self._tables[lane]
            for page in row[row >= 0]:
                self._pages.decref(int(page))
            row[:] = -1
        # hand straight to the best-placed waiter (priority, fair share,
        # FIFO), else back to the free list; the next session overwrites the
        # lane from position 0, so no zeroing
        while self._lane_waiters:
            w = self._scheduler.pick_waiter(self._lane_waiters)
            if w is None:
                self._lane_waiters.clear()  # every parked caller already gone
                break
            self._lane_waiters.remove(w)
            if not w.fut.done():
                # the pick_waiter decision: who was chosen over how many others
                self._journal.event(
                    "waiter_picked", trace_id=w.trace_id, lane=lane, occupancy=self.occupancy_info(),
                    priority=w.priority, waiters=len(self._lane_waiters) + 1,
                )
                w.fut.set_result(lane)
                self._note_occupancy()
                return
        self._free_lanes.append(lane)
        self._note_occupancy()

    def _check_lane(self, lane: int) -> None:
        if self._lane_generation.get(lane) != self._generation:
            raise AllocationFailed(
                "Lane pool was reset after a failed device step, or closed: this session's "
                "KV is gone; the client must re-open the session"
            )

    def _occupancy(self) -> str:
        """Pool occupancy for AllocationFailed messages: lanes and pages, each
        lane's page holdings and the swap tier, so a refused client (and the
        operator reading its logs) can see why."""
        parts = [f"{self._busy_lanes()}/{self.n_lanes} lanes busy", f"{len(self._lane_waiters)} waiters"]
        if self.page_size is not None and self._pages is not None:
            parts.append(f"{self._pages.n_free}/{self.n_pages} pages free")
            if self._tables is not None and self._lane_generation:
                held = ", ".join(f"lane {l}: {self._lane_pages(l)}" for l in sorted(self._lane_generation))
                parts.append(f"pages held: [{held}]")
        if self.swap_pool.max_size_bytes > 0:
            parts.append(
                f"{self._scheduler.suspended_count} suspended, swap "
                f"{self.swap_pool.bytes_in_use}/{self.swap_pool.max_size_bytes} B"
            )
        return "; ".join(parts)

    # ------------------------------------------------------------------ pages

    async def prepare_write(
        self, lane: int, t0: int, t1: int, timeout: Optional[float] = None
    ) -> None:
        """Make token range [t0, t1) of ``lane`` writable: allocate its
        missing pages, and fork every page it shares with the prefix cache
        or another lane (refs > 1) into a fresh copy. On an exhausted pool it
        first tries to preempt an idle lane to the swap tier, then waits
        until a page frees (release_lane, a prefix-cache eviction, a lane
        turning idle), raising AllocationFailed at ``timeout``. No-op in
        dense mode."""
        if self.page_size is None or t1 <= t0:
            return
        self._check_lane(lane)
        if t1 > self.max_length:
            raise ValueError(
                f"Write range [{t0}, {t1}) overflows the lane buffer ({self.max_length} tokens)"
            )
        alloc = self._pages
        # identity preference keeps a lane's pages in sequential memory order
        # at the default pool size
        identity_base = (
            lane * self.max_pages if self.n_pages == self.n_lanes * self.max_pages else None
        )
        deadline = None if timeout is None else time.monotonic() + timeout
        pages_changed = False
        for slot in range(t0 // self.page_size, (t1 - 1) // self.page_size + 1):
            cur = int(self._tables[lane, slot])
            if cur >= 0 and alloc.refs[cur] == 1:
                continue  # already exclusively owned
            preferred = None if identity_base is None else identity_base + slot
            while True:
                page = alloc.try_alloc(preferred=preferred)
                if page is not None:
                    break
                # exhausted: swap an idle lane out first (a no-op without
                # the swap tier), then wait
                if await self._try_preempt(exclude=lane):
                    if self._pages is not alloc:
                        raise AllocationFailed("Lane pool was reset while waiting for a free page")
                    self._check_lane(lane)
                    continue
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    tm.ALLOC_FAILED.inc()
                    raise AllocationFailed(
                        f"No free KV page within {timeout} s ({self._occupancy()})"
                    )
                alloc.freed_event.clear()
                wait = remaining
                if self._can_preempt():
                    # a lane can turn idle without freeing a page, which
                    # freed_event never reports: poll to retry preemption
                    wait = 0.05 if wait is None else min(wait, 0.05)
                try:
                    await asyncio.wait_for(alloc.freed_event.wait(), timeout=wait)
                except asyncio.TimeoutError:
                    pass  # loop once more to produce the AllocationFailed message
                if self._pages is not alloc:
                    raise AllocationFailed("Lane pool was reset while waiting for a free page")
                self._check_lane(lane)
            try:
                if cur >= 0:
                    # a shared page: fork it on the compute thread (serialized
                    # with the steps by the queue), then drop the shared ref
                    await self.queue.submit(self._copy_page, cur, page, priority=PRIORITY_INFERENCE, size=0)
                    alloc.stats["forked"] += 1
                    self._check_lane(lane)
                    alloc.decref(cur)
            except BaseException:
                if self._pages is alloc:
                    alloc.decref(page)  # never reached the table: hand it back
                raise
            self._tables[lane, slot] = page
            pages_changed = True
        if pages_changed:
            # the lanes' page shares changed (a grow or a fork): settle the
            # ledger under the old ones up to now
            self._ledger_sync()

    def _copy_page(self, src: int, dst: int) -> None:
        """Compute-thread body: copy page ``src`` into ``dst`` across every
        block of the pool, in place (the copy-on-write fork), under the
        reset lock like every other pool write outside a step."""
        with self._reset_lock:
            self.backend.copy_page(*self._buffers(), src, dst)

    @property
    def page_epoch(self) -> int:
        return self._page_epoch

    @property
    def page_nbytes(self) -> int:
        """Stored bytes of one page across the span (0 on the dense pool):
        what the prefix cache's summary prices a pinned run at."""
        if self.page_size is None:
            return 0
        return self.backend.kv_bytes_per_token() * self.page_size

    def pin_lane_pages(self, lane: int, t0: int, t1: int) -> Optional[List[int]]:
        """Take a reference on the pages backing token range [t0, t1) of
        ``lane`` (page-aligned), so the prefix cache can share them after the
        lane is released. Returns the pages, or None when the range is not
        fully resident (or the pool is dense). Pair with unpin_pages."""
        if self.page_size is None or self._tables is None:
            return None
        if t0 % self.page_size or t1 % self.page_size:
            raise ValueError(f"pin range [{t0}, {t1}) is not page-aligned (page {self.page_size})")
        pages = [int(p) for p in self._tables[lane, t0 // self.page_size : t1 // self.page_size]]
        if any(p < 0 for p in pages):
            return None
        for page in pages:
            # swarmlint: disable=paired-refcount — ownership transfer: the refs belong to the caller (the prefix cache), released through unpin_pages; no code below this loop can raise
            self._pages.incref(page)
        self._ledger_sync()  # refcounts moved: the lane's share of those pages shrank
        return pages

    def unpin_pages(self, pages: Sequence[int], epoch: int) -> None:
        """Drop references taken by pin_lane_pages. Pins from an earlier
        epoch are ignored: the reset rebuilt the allocator, and those pages
        no longer exist to decref."""
        if self.page_size is None or self._pages is None or epoch != self._page_epoch:
            return
        for page in pages:
            self._pages.decref(int(page))
        self._ledger_sync()  # pins released: the other holders' shares grew

    def lane_resident(self, lane: int) -> bool:
        """The lane's pages are in the pool: it is not suspended, and no
        swap-out of it is under way."""
        slot = self._scheduler.lanes.get(lane)
        return slot is None or (slot.swap is None and not slot.suspending)

    def adopt_pages(self, lane: int, pages: Sequence[int]) -> None:
        """Point ``lane``'s first len(pages) table slots at resident (pinned)
        pages: a prefix-cache hit that copies ZERO bytes. The lane holds them
        shared; its first write into one forks it (prepare_write). The lane
        must be resident (``lane_resident``): a swap-in would write its old
        row over the adopted slots."""
        if self.page_size is None or self._tables is None or len(pages) > self.max_pages:
            raise ValueError(f"cannot adopt {len(pages)} pages into a lane of {self.max_pages} slots")
        row = self._tables[lane]
        for slot, page in enumerate(pages):
            cur = int(row[slot])
            self._pages.incref(int(page))
            if cur >= 0:
                self._pages.decref(cur)
            row[slot] = int(page)
        if len(pages):
            tm.PREFIX_ADOPT.inc()
            self._ledger_sync()  # the lane now shares the pinned pages

    # ------------------------------------------------------ preemption / swap

    @property
    def ledger(self):
        """The resource ledger this batcher bills to."""
        return self._ledger

    def _lane_pages(self, lane: int) -> int:
        """Resident pages of a lane (the scheduler's pages_fn)."""
        if self._tables is None:
            return 0
        return int((self._tables[lane] >= 0).sum())

    def _can_preempt(self) -> bool:
        return (
            self.page_size is not None and self._scheduler.policy != "off" and self.swap_pool.max_size_bytes > 0
        )

    @property
    def swap_host_memory(self) -> str:
        """Where swapped pages land: page-locked memory from a pool on the
        card, ordinary memory from one on the CPU."""
        return "pinned" if self.backend.device.type == "cuda" else "pageable"

    def _lane_lock(self, lane: int) -> AsyncTryLock:
        lock = self._lane_locks.get(lane)
        if lock is None:
            # one sanitizer name for all: lane locks are one class, never
            # nested in each other except through a trylock
            lock = self._lane_locks[lane] = make_async_lock("batching.lane_lock")
        return lock

    @contextlib.asynccontextmanager
    async def _lane_busy(self, lane: int):
        """Guard of every operation on a lane: a suspended lane swaps back in
        first, then the in-flight count keeps it unpreemptable until the
        operation ends. No await between the residency check returning and
        the increment, so the pair is atomic on the event loop."""
        await self._ensure_resident(lane)
        self._inflight[lane] = self._inflight.get(lane, 0) + 1
        self._scheduler.touch(lane)
        try:
            yield
        finally:
            self._inflight[lane] -= 1
            # the end of an operation is when a lane turns idle, so that is
            # when page waiters should retry preemption: wake them now
            if self._inflight[lane] == 0 and self._pages is not None and self.swap_pool.max_size_bytes > 0:
                self._pages.freed_event.set()

    def _lane_idle(self, lane: int, *, ignore_lock: bool = False) -> bool:
        """A lane is preemptable only while nothing touches it: no step
        pending or in flight, no generation or prefill stream, no exclusive
        op, no swap under way, and pages resident to reclaim.
        ``ignore_lock`` serves the re-check in ``_swap_out_lane``, which
        holds the lane lock itself."""
        if self._lane_generation.get(lane) != self._generation:
            return False
        if self._inflight.get(lane, 0) > 0 or lane in self._gen_states:
            return False
        if any(p.lane == lane for p in self._prefill_queue) or any(e[0] == lane for e in self._pending):
            return False
        if not ignore_lock:
            lock = self._lane_locks.get(lane)
            if lock is not None and lock.locked():
                return False
        return self._lane_pages(lane) > 0

    async def _try_preempt(self, exclude: int) -> bool:
        """The pool is exhausted: swap ONE idle victim lane, of equal or
        lower priority than lane ``exclude``, out to host memory. True when
        its pages were freed (the caller retries at once); False when there
        is no victim (the caller waits)."""
        if not self._can_preempt():
            return False
        sched = self._scheduler
        req = sched.lanes.get(exclude)
        candidates = [l for l in list(self._lane_generation) if l != exclude and self._lane_idle(l)]
        victim = sched.pick_victim(candidates, max_priority=req.priority if req is not None else None)
        if victim is None:
            return False
        # the decision (its outcome is a following swap_out event, or none):
        # who was evicted, for whom, under what occupancy
        self._journal.event(
            "victim_selected", trace_id=sched.trace_id_of(victim), lane=victim, occupancy=self.occupancy_info(),
            requester_lane=exclude, requester_trace_id=sched.trace_id_of(exclude), policy=sched.policy,
            candidates=list(candidates),
        )
        return await self._swap_out_lane(victim)

    async def _swap_out_lane(self, lane: int) -> bool:
        """Suspend ``lane``: copy its resident pages to host memory on the
        compute thread, then free them and clear its table row; a swap-in
        may later land the content on other pages. Aborts (False) if the
        lane's state moved while the copy ran: a release, a pool reset or
        a racing operation each invalidate it."""
        sched = self._scheduler
        slot = sched.lanes.get(lane)
        if slot is None or slot.swap is not None or slot.suspending:
            return False
        lock = self._lane_lock(lane)
        # a trylock: a held lane lock means the lane is busy, and a blocking
        # acquire would invert the lane lock -> turnstile order (this runs
        # with the turnstile held when a swap-in preempts)
        if not lock_try_acquire_nowait(lock):
            return False
        try:
            if not self._lane_idle(lane, ignore_lock=True) or sched.lanes.get(lane) is not slot:
                return False
            alloc = self._pages
            gen = self._lane_generation.get(lane)
            row = self._tables[lane]
            slots = np.flatnonzero(row >= 0).astype(np.int32)
            if slots.size == 0:
                return False
            pages = row[slots].astype(np.int32).copy()
            nbytes = int(slots.size) * self.page_nbytes
            if not self.swap_pool.try_reserve(nbytes):
                return False  # the swap tier is full: this victim stays
            slot.suspending = True
            try:
                k_host, v_host = await self.queue.submit(
                    self._swap_out_device, lane, pages, priority=PRIORITY_INFERENCE, size=0,
                )
            except asyncio.CancelledError:
                self.swap_pool.free(nbytes)
                slot.suspending = False
                sched.stats["swap_aborted"] += 1
                raise
            except Exception as e:
                # the copy only reads the pool, which stays intact: fall back
                # to waiting rather than fail the requester for the victim
                logger.warning(f"Swap-out copy of lane {lane} failed: {e!r}")
                self.swap_pool.free(nbytes)
                slot.suspending = False
                sched.stats["swap_aborted"] += 1
                return False
            # only now, the host copy landed and nothing moved, do the pages free
            if (
                sched.lanes.get(lane) is not slot
                or self._pages is not alloc
                or self._lane_generation.get(lane) != gen
                or gen != self._generation
                or not np.array_equal(self._tables[lane][slots], pages)
            ):
                self.swap_pool.free(nbytes)
                slot.suspending = False
                sched.stats["swap_aborted"] += 1
                return False
            for page in pages:
                alloc.decref(int(page))
            self._tables[lane, slots] = -1
            slot.swap = SwapEntry(
                k=k_host, v=v_host, slots=slots, nbytes=nbytes, generation=gen, suspended_at=time.monotonic(),
            )
            slot.suspending = False
            sched.stats["preemptions"] += 1
            sched.stats["swap_outs"] += 1
            tm.PREEMPTIONS.inc()
            tm.SWAP_OUT_BYTES.inc(nbytes)
            key = self._ledger_keys.get(lane)
            if key is not None:
                self._ledger.note_swap(key, out_bytes=nbytes)
            self._journal.event(
                "swap_out", trace_id=slot.trace_id, lane=lane, occupancy=self.occupancy_info(),
                pages=int(slots.size), nbytes=nbytes,
            )
            self._note_occupancy()
            logger.debug(
                f"Preempted lane {lane}: {slots.size} pages to the host "
                f"({self.swap_pool.bytes_in_use}/{self.swap_pool.max_size_bytes} B used)"
            )
            return True
        finally:
            lock.release()

    def _swap_out_device(self, lane: int, pages: np.ndarray):
        """Compute-thread body: copy the victim's pages to host memory. It
        returns once the copy has landed, and only reads the pool: the pages
        free after the event loop validates the suspend."""
        with self._reset_lock:
            t0 = time.perf_counter()
            k, v = self.backend.swap_out_pages(*self._buffers(), pages)
            self._note_swap_event("out", lane, len(pages), time.perf_counter() - t0)
            return k, v

    def _note_swap_event(self, direction: str, lane: int, n_pages: int, seconds: float) -> None:
        self.swap_events.append({
            "dir": direction, "lane": lane, "pages": int(n_pages),
            "bytes": int(n_pages) * self.page_nbytes, "seconds": seconds,
        })

    async def _ensure_resident(self, lane: int) -> None:
        """Transparent resume: a suspended lane (or one whose suspend is
        under way: the lane lock queues us behind it) swaps back in before
        the caller's operation goes on."""
        slot = self._scheduler.lanes.get(lane)
        if slot is None or (slot.swap is None and not slot.suspending):
            return
        async with self._lane_lock(lane):
            slot = self._scheduler.lanes.get(lane)
            if slot is None or slot.swap is None:
                return  # the suspend aborted, or the lane was released
            await self._swap_in(lane, slot)

    async def _swap_in(self, lane: int, slot) -> None:
        """Resume a suspended lane (its lane lock held): take fresh pages,
        all at once and preempting others if needed, then write the host
        copy onto them and rewrite the table row, on the compute thread."""
        entry = slot.swap
        self._check_lane(lane)
        # only the allocation takes turns: once this resumer holds its pages
        # the next may negotiate while the write runs
        async with self._swap_in_turnstile:
            pages = await self._alloc_pages(lane, entry.slots)
        alloc = self._pages
        pages_arr = np.asarray(pages, np.int32)
        try:
            await self.queue.submit(self._swap_in_device, lane, entry, pages_arr, priority=PRIORITY_INFERENCE, size=0)
        except BaseException as e:
            if self._pages is alloc:
                for page in pages:
                    alloc.decref(int(page))
            self._maybe_reset_pool(e)  # a device fault mid-write: the pool is not trusted
            raise
        slot.swap = None
        slot.resumed_at = time.monotonic()
        self.swap_pool.free(entry.nbytes)
        self._scheduler.stats["swap_ins"] += 1
        tm.SWAP_IN_BYTES.inc(entry.nbytes)
        key = self._ledger_keys.get(lane)
        if key is not None:
            self._ledger.note_swap(key, in_bytes=entry.nbytes)
        self._journal.event(
            "swap_in", trace_id=slot.trace_id, lane=lane, occupancy=self.occupancy_info(),
            pages=int(entry.slots.size), nbytes=entry.nbytes,
        )
        self._note_occupancy()
        logger.debug(f"Resumed lane {lane}: {entry.slots.size} pages swapped in")

    def _swap_in_device(self, lane: int, entry: SwapEntry, pages: np.ndarray) -> None:
        """Compute-thread body: write a swap entry onto fresh pages in place,
        then point the lane's table row at them, between steps. Under the
        reset lock, with the generation checked there, as for a check-in."""
        with self._reset_lock:
            self._check_lane(lane)
            if entry.generation != self._generation:
                raise AllocationFailed("Lane pool was reset while this session was swapped out")
            t0 = time.perf_counter()
            self.backend.swap_in_pages(*self._buffers(), entry.k, entry.v, pages)
            self._tables[lane, entry.slots] = pages
            self._note_swap_event("in", lane, len(pages), time.perf_counter() - t0)

    async def _alloc_pages(self, lane: int, slots: np.ndarray) -> List[int]:
        """All-or-nothing pages for a swap-in: take len(slots) pages only
        once that many are free at once (two resumers each holding part of a
        set would deadlock), preempting other lanes when the pool is short.
        Identity pages are preferred."""
        alloc = self._pages
        n = int(len(slots))
        identity_base = lane * self.max_pages if self.n_pages == self.n_lanes * self.max_pages else None
        timeout = 30.0 if self.alloc_timeout is None else self.alloc_timeout
        deadline = time.monotonic() + timeout
        while True:
            if self._pages is not alloc:
                raise AllocationFailed("Lane pool was reset while waiting for a free page")
            self._check_lane(lane)
            if alloc.n_free >= n:
                pages = []
                for slot in slots:
                    page = alloc.try_alloc(preferred=None if identity_base is None else identity_base + int(slot))
                    if page is None:
                        raise RuntimeError("page allocator invariant broken: n_free overstated")
                    pages.append(page)
                return pages
            if await self._try_preempt(exclude=lane):
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                tm.ALLOC_FAILED.inc()
                raise AllocationFailed(f"No free KV page for swap-in within {timeout} s ({self._occupancy()})")
            alloc.freed_event.clear()
            try:
                # bounded, as in prepare_write: a lane turning idle frees nothing
                await asyncio.wait_for(alloc.freed_event.wait(), timeout=min(remaining, 0.05))
            except asyncio.TimeoutError:
                pass  # loop once more to produce the AllocationFailed message

    # ------------------------------------------------------------- the ledger

    def _note_occupancy(self) -> None:
        """An occupancy boundary (admission, release, swap): refresh the
        pool gauges (occupancy only changes here, so the decode tick pays
        nothing for them), settle the ledger at the new rates, and let the
        noisy-neighbor detector look while the admission queue is current;
        its evidence goes to the journal."""
        tm.LANES_BUSY.set(self._busy_lanes())
        if self.page_size is not None:
            tm.PAGES_TOTAL.set(self.n_pages)
            tm.PAGES_FREE.set(self._pages.n_free if self._pages is not None else self.n_pages)
            if self._pages is not None:
                info = self._pages.fragmentation_info()
                tm.PAGE_FRAGMENTATION.set(info["frag"])
                tm.PAGE_LARGEST_RUN.set(info["largest_run"])
                for bucket, child in tm.PAGE_FREE_RUN_CHILDREN.items():
                    child.set(info["run_hist"][bucket])
        mc = self.memory_cache
        if mc is not None and mc.max_size_bytes < 2**60:
            tm.HBM_HEADROOM.set(mc.bytes_left)
        tm.SWAP_RESIDENCY_OLDEST.set(self._scheduler.oldest_swap_age())
        self._ledger_sync()
        if self._lane_waiters:
            evidence = self._ledger.check_noisy([w.peer_id for w in self._lane_waiters if not w.fut.done()])
            if evidence is not None:
                self._journal.event("noisy_neighbor", occupancy=self.occupancy_info(), **evidence)

    def _ledger_sync(self) -> None:
        """Settle the ledger and install the new piecewise-constant rates:
        each lane's fractional page holding (1/refcount a referenced page;
        prefix-cache pins hold the rest) and the pool's occupancy, whose
        integral the lanes' shares sum to. Called where tables or refcounts
        change, never on the decode path."""
        weights: Dict[str, float] = {}
        occupied = 0.0
        if self.page_size is not None and self._pages is not None and self._tables is not None:
            occupied = float(self.n_pages - self._pages.n_free)
            if self._ledger_keys:
                lanes = list(self._ledger_keys)
                shares = self._pages.fractional_shares(self._tables[lanes])
                weights = {self._ledger_keys[lane]: float(sh) for lane, sh in zip(lanes, shares)}
        self._ledger.set_rates(weights, occupied)

    def pop_usage_delta(self, lane: int) -> Optional[dict]:
        """The lane's resource usage since the last call: the tenant's own
        bill, which rides step_meta as ``usage`` (``usage_report`` in both
        clients sums it). None for an empty delta."""
        key = self._ledger_keys.get(lane)
        if key is None:
            return None
        delta = self._ledger.usage_delta(key)
        if delta and delta.get("spec_proposed"):
            delta.update(derive_efficiency(delta))
        return delta or None

    def _ledger_account_step(self, duration: float, *, decode_lanes=(), gen_lanes=(), prefill=None) -> None:
        """Bill one batched step (compute thread): its wall splits equally
        over the lanes that rode it, each decode or generating lane gets a
        decode token and the prefill chunk's lane its tokens. ``prefill`` is
        (lane, tokens)."""
        keys = []
        for lane in (*decode_lanes, *gen_lanes):
            key = self._ledger_keys.get(lane)
            if key is not None:
                keys.append(key)
                self._ledger.note_tokens(key, decode=1)
        if prefill is not None:
            key = self._ledger_keys.get(prefill[0])
            if key is not None:
                keys.append(key)
                self._ledger.note_tokens(key, prefill=int(prefill[1]))
        self._ledger.note_compute(keys, duration)

    # ------------------------------------------------------------------ steps

    async def step(self, lane: int, hidden: torch.Tensor, position: int) -> torch.Tensor:
        """One decode token for ``lane`` (hidden [1, 1, hidden]), coalesced
        with whatever other lanes are pending when the device is free.
        Returns [1, 1, hidden] on the host."""
        t_enq = time.perf_counter()
        async with self._lane_busy(lane):
            self._check_lane(lane)
            # grow the lane to cover this token BEFORE the step: allocation may
            # await a freed page, the step itself never blocks
            await self.prepare_write(lane, int(position), int(position) + 1, timeout=self.alloc_timeout)
            fut = asyncio.get_running_loop().create_future()
            self._enq_t[lane] = t_enq
            self._pending.append((lane, hidden, int(position), fut, self._generation))
            self._spawn_flush_loop()
            return await fut

    async def prefill_lane(self, lane: int, hidden: torch.Tensor, position: int) -> torch.Tensor:
        """Admit a multi-token prefill (hidden [1, seq, hidden]) into the
        mixed-step queue: pages for the whole range are allocated up front
        (the only blocking point), then the flush loop feeds one page-aligned
        chunk per tick alongside every pending decode lane. Returns the span
        output for the whole range, [1, seq, hidden] on the host. Paged mode
        only: the dense pool prefills through ``run_exclusive_chunks``."""
        async with self._lane_busy(lane):
            if self.page_size is None:
                raise RuntimeError("prefill_lane serves the paged pool; a dense lane prefills through run_exclusive_chunks")
            self._check_lane(lane)
            total, position = int(hidden.shape[1]), int(position)
            if position + total > self.max_length:
                raise ValueError(
                    f"Prefill of {total} tokens at position {position} overflows the lane "
                    f"buffer ({self.max_length} tokens)"
                )
            await self.prepare_write(lane, position, position + total, timeout=self.alloc_timeout)
            plan = self.backend.chunk_plan(1, total, page_size=self.page_size, start=position)
            st = _LanePrefillState(
                future=asyncio.get_running_loop().create_future(),
                generation=self._lane_generation[lane],
                lane=lane,
                hidden=hidden.detach().to("cpu", torch.float32).contiguous(),
                position=position,
                offset=0,
                cap=int(max(plan)),
                n_total=position + total,
                outs=[],
                enqueued=time.perf_counter(),
            )
            self._prefill_queue.append(st)
            self._spawn_flush_loop()
            try:
                return await st.future
            finally:
                if st in self._prefill_queue:
                    self._prefill_queue.remove(st)

    async def generate_lane(self, lane: int, last_hidden: torch.Tensor, position: int, n_tokens: int,
                            sampling: Optional[dict] = None) -> np.ndarray:
        """Server-side generation on a pooled lane: ``n_tokens`` tokens from
        ``last_hidden`` (the span output of the last fed token, [1, 1,
        hidden]), feeding the first n_tokens - 1 into the lane from
        ``position`` on (the last is never fed, as ``generate_tokens``).
        The pages of the whole stream are reserved first; the first token
        is picked by a queue task of its own (``sample_from_hidden``), the
        rest by the flush loop's generation steps, one a tick, beside every
        other generating and decoding lane. ``sampling``: a validated
        ``gen_sampling`` dict, or None for greedy. Returns tokens [1,
        n_tokens] int32."""
        async with self._lane_busy(lane):
            if self.gen_params is None:
                raise RuntimeError("This batcher has no client leaves loaded for server-side generation")
            self._check_lane(lane)
            position, n_tokens = int(position), int(n_tokens)
            if position + n_tokens - 1 > self.max_length:
                raise ValueError(
                    f"Generating {n_tokens} tokens at position {position} overflows "
                    f"the lane buffer ({self.max_length} tokens)"
                )
            if n_tokens > 1:
                # the flush loop cannot wait for a page mid-stream
                await self.prepare_write(lane, position, position + n_tokens - 1, timeout=self.alloc_timeout)

            def boot():
                self._check_lane(lane)
                return self.backend.sample_from_hidden(self.gen_params, last_hidden, sampling)

            t0 = int((await self.queue.submit(boot, priority=PRIORITY_INFERENCE, size=1))[0])
            if n_tokens <= 1:
                return np.asarray([[t0]], np.int32)
            st = _LaneGenState(
                future=asyncio.get_running_loop().create_future(), generation=self._lane_generation[lane],
                token=t0, position=position, remaining=n_tokens - 1, collected=[t0], enqueued=time.perf_counter(),
            )
            if sampling is not None:
                st.do_sample = bool(sampling.get("do_sample", False))
                st.temperature = float(sampling.get("temperature", 1.0))
                st.top_k = int(sampling.get("top_k", 0) or 0)
                st.top_p = float(sampling.get("top_p", 1.0) or 1.0)
                st.repetition_penalty = float(sampling.get("repetition_penalty", 1.0) or 1.0)
                # the draft conditions on context + collected; a missing
                # context costs acceptance only, never the stream
                ctx = sampling.get("context")
                if ctx:
                    st.context = [int(t) for t in ctx]
                if st.do_sample:
                    # every draw of the stream at once: a step then reads its own
                    offset = int(sampling.get("offset", 0))
                    st.uniforms = uniform_for_draw(int(sampling.get("seed", 0)), offset + 1 + np.arange(st.remaining))
                if st.repetition_penalty != 1.0:
                    vocab = self.backend.cfg.vocab_size
                    seen = np.zeros((vocab,), bool)
                    for t in (*(sampling.get("context") or ()), t0):
                        if 0 <= int(t) < vocab:
                            seen[int(t)] = True
                    st.seen = seen
            self._gen_states[lane] = st
            self._spawn_flush_loop()
            try:
                return await st.future
            finally:
                if self._gen_states.get(lane) is st:
                    del self._gen_states[lane]

    def pop_step_timing(self, lane: int) -> Optional[dict]:
        return self._step_timing.pop(lane, None)

    def pop_step_fp(self, lane: int) -> Optional[list]:
        """Consume the finished step's fused fingerprint of ``lane``'s last
        row (FP_DIM floats, ops/fingerprint.py), which the handler puts in
        the reply's step_meta; None when fingerprints are off or no batched
        step ran."""
        return self._step_fp.pop(lane, None)

    def _capture_step_fp(self, lanes, chunk_lane: Optional[int] = None) -> None:
        """Stash the backend's fused fingerprints of the step that just ran
        (compute thread, after its outputs reached the host): each of
        ``lanes`` its row's, and ``chunk_lane`` the mixed step's chunk
        digest (of its last valid row, what the client re-derives from the
        assembled prefill reply)."""
        fp, chunk_fp = self.backend.pop_step_fp()
        if fp is not None:
            host = fp.cpu().numpy()
            for lane in lanes:
                self._step_fp[lane] = [float(x) for x in host[lane]]
        if chunk_fp is not None and chunk_lane is not None:
            self._step_fp[chunk_lane] = [float(x) for x in chunk_fp.cpu().numpy().reshape(-1)]

    def _spawn_flush_loop(self) -> None:
        """(Re)start the flush loop unless it is already draining; the strong
        reference keeps the task alive and the callback surfaces a crash."""
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.create_task(self._flush_loop())
            self._flush_task.add_done_callback(_log_crash)

    async def _flush_loop(self) -> None:
        while self._pending or self._gen_states or self._prefill_queue:
            batch, self._pending = self._pending, []
            # entries enqueued before a pool reset must fail loudly: running
            # them against the zeroed pool would silently corrupt their output
            stale = [e for e in batch if e[4] != self._generation]
            batch = [e for e in batch if e[4] == self._generation]
            for *_, fut, _gen in stale:
                if not fut.done():
                    fut.set_exception(AllocationFailed("Lane pool was reset while this step was pending"))
            for lane, st in list(self._gen_states.items()):
                if st.generation != self._generation:
                    del self._gen_states[lane]
                    if not st.future.done():
                        st.future.set_exception(AllocationFailed("Lane pool was reset while this step was pending"))
            for pst in [p for p in self._prefill_queue if p.generation != self._generation]:
                self._prefill_queue.remove(pst)
                if not pst.future.done():
                    pst.future.set_exception(
                        AllocationFailed("Lane pool was reset while this step was pending")
                    )
            gen_states = dict(self._gen_states)
            # speculating lanes leave the generation step for their own
            # verify step; its rows spend the prefill budget, as chunk rows
            spec_states = self._pick_spec_lanes(gen_states)
            pf = self._next_prefill_chunk(len(batch) + len(gen_states) + len(spec_states),
                                          spec_tokens=len(spec_states) * (self.spec_k + 1))
            if not batch and not gen_states and not spec_states and pf is None:
                continue
            try:
                toks = chunk_out = spec_res = None
                if spec_states:
                    spec_res = await self.queue.submit(
                        self._run_batch_spec, spec_states,
                        priority=PRIORITY_INFERENCE, size=len(spec_states) * (self.spec_k + 1),
                    )
                if gen_states:
                    out, toks = await self.queue.submit(
                        self._run_batch_gen, batch, gen_states,
                        priority=PRIORITY_INFERENCE, size=len(batch) + len(gen_states),
                    )
                    if pf is not None:
                        # the generation step has no prefill half: the chunk
                        # rides its own mixed step this tick
                        _, chunk_out = await self.queue.submit(
                            self._run_batch_mixed, [], pf, priority=PRIORITY_INFERENCE, size=pf[1],
                        )
                elif pf is not None:
                    out, chunk_out = await self.queue.submit(
                        self._run_batch_mixed, batch, pf,
                        priority=PRIORITY_INFERENCE, size=len(batch) + pf[1],
                    )
                elif batch:
                    out = await self.queue.submit(
                        self._run_batch, batch, priority=PRIORITY_INFERENCE, size=len(batch)
                    )
            except BaseException as e:  # noqa: BLE001 — deliver to every waiter
                for *_, fut, _gen in batch:
                    if not fut.done():
                        fut.set_exception(e)
                for lane, st in itertools.chain(gen_states.items(), spec_states.items()):
                    if self._gen_states.get(lane) is st:
                        del self._gen_states[lane]
                    if not st.future.done():
                        st.future.set_exception(e)
                if pf is not None:
                    pst = pf[0]
                    if pst in self._prefill_queue:
                        self._prefill_queue.remove(pst)
                    if not pst.future.done():
                        pst.future.set_exception(e)
                if isinstance(e, asyncio.CancelledError):
                    raise
                self._maybe_reset_pool(e)
                continue
            for lane, _, _, fut, _gen in batch:
                if not fut.done():
                    fut.set_result(out[lane : lane + 1])
            if pf is not None:
                self._advance_prefill(pf[0], pf[1], chunk_out)
            if spec_res is not None:
                self._commit_spec_results(spec_states, *spec_res)
            if toks is not None:
                self._advance_gen(gen_states, toks)

    def _advance_gen(self, gen_states: Dict[int, _LaneGenState], toks: np.ndarray) -> None:
        """Event-loop side of a generation step: collect each lane's token,
        advance its feed position and draw index, and resolve finished
        streams."""
        for lane, st in gen_states.items():
            if self._gen_states.get(lane) is not st:
                continue  # released or cancelled while the step ran
            tok = int(toks[lane])
            st.collected.append(tok)
            st.token = tok
            st.position += 1
            if st.seen is not None and 0 <= tok < st.seen.shape[0]:
                st.seen[tok] = True
            st.remaining -= 1
            if st.remaining <= 0:
                del self._gen_states[lane]
                self._step_timing[lane] = self._gen_step_timing(st, "gen")
                if not st.future.done():
                    st.future.set_result(np.asarray([st.collected], np.int32))

    def _pick_spec_lanes(self, gen_states: Dict[int, _LaneGenState]) -> Dict[int, _LaneGenState]:
        """This tick's speculating lanes, moved OUT of ``gen_states`` (the
        rest take the generation step). Eligible: a draft is loaded, the pool
        is paged, the lane's cooldown is over, and the lane has room for the
        best case: the verify step writes spec_k + 1 rows at positions
        p..p+spec_k, inside the pages ``generate_lane`` reserved (its
        remaining rows from the current position)."""
        if self.draft is None or self.spec_k < 1 or self.page_size is None:
            return {}
        spec: Dict[int, _LaneGenState] = {}
        for lane, st in list(gen_states.items()):
            if st.spec_cooldown > 0:
                st.spec_cooldown -= 1
                continue
            if st.remaining < self.spec_k + 1:
                continue
            spec[lane] = st
            del gen_states[lane]
        return spec

    def _gen_step_timing(self, st: _LaneGenState, variant: str) -> dict:
        """A finished stream's step_meta timing; a stream that speculated
        also reports its lifetime acceptance."""
        timing = {"queue_s": st.queue_s, "compute_s": st.compute_s, "variant": variant}
        if st.spec_proposed:
            timing["spec_proposed"] = st.spec_proposed
            timing["spec_accepted"] = st.spec_accepted
            timing["acceptance_rate"] = round(st.spec_accepted / st.spec_proposed, 4)
        return timing

    def _commit_spec_results(self, spec_states: Dict[int, _LaneGenState], g_hat: np.ndarray,
                             n_emit: np.ndarray) -> None:
        """Event-loop side of a spec step: commit each lane's
        g_hat[lane, :n_emit[lane]] (the target's own tokens: plain decode's
        stream) and advance its position by the count; the rejected rows
        stay in its pages, masked and later written over. Then the
        acceptance EMA: a lane below the floor decodes plain for a
        cooldown."""
        for lane, st in spec_states.items():
            if self._gen_states.get(lane) is not st:
                continue  # released or cancelled while the step ran
            m = int(n_emit[lane])  # in [1, spec_k + 1] <= st.remaining
            emitted = [int(t) for t in g_hat[lane, :m]]
            for tok in emitted:
                st.collected.append(tok)
                if st.seen is not None and 0 <= tok < st.seen.shape[0]:
                    st.seen[tok] = True
            st.token = emitted[-1]
            st.position += m
            st.remaining -= m
            accepted = m - 1  # of spec_k proposed drafts
            st.spec_proposed += self.spec_k
            st.spec_accepted += accepted
            alpha = self._spec_ema_alpha
            st.spec_ema = (1.0 - alpha) * st.spec_ema + alpha * (accepted / self.spec_k)
            if st.spec_ema < self._spec_min_accept and st.remaining > 0:
                ema = st.spec_ema
                st.spec_cooldown = self._spec_cooldown_ticks
                st.spec_ema = 1.0  # optimistic restart after the cooldown
                self.stats["spec_disabled"] += 1
                tm.SPEC_DISABLED.inc()
                self._journal.event(
                    "spec_disabled", lane=lane, ema=round(ema, 4), floor=self._spec_min_accept,
                    cooldown_ticks=self._spec_cooldown_ticks, proposed=st.spec_proposed, accepted=st.spec_accepted,
                )
            if st.remaining <= 0:
                del self._gen_states[lane]
                self._step_timing[lane] = self._gen_step_timing(st, "spec")
                if not st.future.done():
                    st.future.set_result(np.asarray([st.collected], np.int32))

    def max_chunk(self) -> int:
        """The longest chunk a mixed step can carry: the prefill budget, or
        one page when decode pressure lifts a smaller budget to a page
        (``_prefill_budget``), at most a lane. Page alignment only shortens
        a chunk."""
        return min(max(self.prefill_token_budget, self.page_size), self.max_length)

    def _prefill_budget(self, n_decode: int, spec_tokens: int = 0) -> int:
        """Per-tick fairness: the prefill token budget halves under decode
        pressure (more than half the lanes stepping), but never below one
        page, so prefills always progress and decode lanes never wait on
        more than one bounded chunk per tick. Verify rows spend from the
        same budget (they are chunk writes riding the tick), with the same
        one-page floor."""
        budget = self.prefill_token_budget
        if n_decode > max(1, self.n_lanes // 2):
            budget = max(self.page_size, budget // 2)
        if spec_tokens:
            budget = max(self.page_size, budget - int(spec_tokens))
        return budget

    def _next_prefill_chunk(self, n_decode: int, spec_tokens: int = 0) -> Optional[Tuple[_LanePrefillState, int]]:
        """The chunk riding this tick: the queue head's next ``take`` tokens,
        capped by the chunk cap and the budget, its END aligned to an
        absolute page boundary unless it is the prefill's last chunk.
        Returns (state, take) or None."""
        if not self._prefill_queue:
            return None
        st = self._prefill_queue[0]
        remaining = st.hidden.shape[1] - st.offset
        take = min(remaining, st.cap, self._prefill_budget(n_decode, spec_tokens))
        if take < remaining:
            end = st.position + take
            aligned = end - end % self.page_size
            if aligned > st.position:
                take = aligned - st.position
        if st.offset == 0 and not st.outs:
            # first chunk entering a step: the admission to first-compute gap
            st.queue_s = max(time.perf_counter() - st.enqueued, 0.0)
            tm.PREFILL_QUEUE_WAIT.observe(st.queue_s)
        return st, max(int(take), 1)

    def _advance_prefill(self, st: _LanePrefillState, take: int, chunk_out: torch.Tensor) -> None:
        """Event-loop side of a mixed step: collect the chunk's output,
        advance the cursor, resolve a finished prefill, and rotate the queue
        so concurrent prefills share the budget round-robin."""
        if st not in self._prefill_queue:
            return  # released or cancelled while the step ran
        st.outs.append(chunk_out)
        st.offset += take
        st.position += take
        if st.offset >= st.hidden.shape[1]:
            self._prefill_queue.remove(st)
            self._step_timing[st.lane] = {
                "queue_s": st.queue_s, "compute_s": st.compute_s, "variant": "prefill",
            }
            if not st.future.done():
                st.future.set_result(torch.cat(st.outs, dim=1))
        elif len(self._prefill_queue) > 1:
            self._prefill_queue.append(self._prefill_queue.pop(0))

    def _maybe_reset_pool(self, error: BaseException) -> None:
        """A step that failed on the device (a RuntimeError: a CUDA fault or
        a refused launch) may have left the in-place pool half written or
        the device state unknown. Zero the pool and invalidate every
        outstanding lane (generation bump) so their next step fails loudly
        and clients re-open. Other failures (allocation, validation) leave
        the pool intact: a failed step only ever writes rows at or past its
        own lanes' frontiers."""
        if self._handles is None or not isinstance(error, RuntimeError):
            return
        if self._lockstep:
            # under lockstep a failed op degraded the group (multihost
            # _degrade_on_failure): a leader-local reset would desync the
            # workers' mirrors; the outstanding sessions are invalidated
            with self._reset_lock:
                self._generation += 1
            logger.warning(f"Lockstep pool step failed ({error!r}): invalidating outstanding pooled sessions")
            return
        logger.warning(f"Pool step failed on the device ({error!r}): resetting the lane pool")
        with self._reset_lock:
            self._generation += 1
            self.stats["pool_resets"] += 1
            if self._pages is not None:
                self._pages.freed_event.set()  # wake waiters on the dead allocator
            if self.page_size is not None:
                # every table reference and pin died with the lanes: rebuild
                # the allocator and bump the epoch, so pins taken against the
                # old pool unpin as no-ops. Swap entries target the dead
                # generation too: drop them and their host bytes, so
                # suspended sessions fail loudly through _check_lane
                self._scheduler.reset()
                self._page_epoch += 1
                self._pages = PageAllocator(self.n_pages)
                self._tables[:] = -1
            for handle in self._handles:
                self.memory_cache.reset_buffer(handle)

    def _lane_inputs(self, batch) -> Tuple[torch.Tensor, np.ndarray]:
        """[n_lanes, 1, hidden] float32 host buffer and [n_lanes] positions,
        idle lanes at the sentinel ``max_length``."""
        hidden = torch.zeros((self.n_lanes, 1, self.backend.hidden_size), dtype=torch.float32)
        positions = np.full((self.n_lanes,), self.max_length, np.int32)
        for lane, h, pos, _fut, _gen in batch:
            hidden[lane] = h.reshape(1, -1)
            positions[lane] = pos
        return hidden, positions

    def _run_batch(self, batch) -> torch.Tensor:
        """Compute-thread body: ONE decode step for every pending lane."""
        # generation guards on both sides of the step: a reset must never be
        # followed by decoding against the zeroed pool
        if batch[0][4] != self._generation:
            raise AllocationFailed("Lane pool was reset before this batched step ran")
        t_step = time.perf_counter()
        hidden, positions = self._lane_inputs(batch)
        if self.page_size is not None:
            # the tables are copied: the event loop may grow OTHER lanes while
            # this step runs, never slots this step reads or writes
            out, _ = self.backend.paged_decode_step(
                hidden, self._buffers(), positions, self._tables.copy()
            )
        else:
            out, _ = self.backend.batched_decode_step(hidden, self._buffers(), positions)
        host_out = out.cpu()  # waits for the step to finish on the device
        with self._reset_lock:
            if batch[0][4] != self._generation:
                raise AllocationFailed("Lane pool was reset while this batched step ran")
        duration = time.perf_counter() - t_step
        if self.page_size is not None:
            tm.STEP_PAGED.observe(duration)
            tm.STEPS_PAGED.inc()
        else:
            tm.STEP_DENSE.observe(duration)
            tm.STEPS_DENSE.inc()
        tm.DECODE_TOKENS.inc(len(batch))
        self._count_step(batch, t_step, duration)
        self._ledger_account_step(duration, decode_lanes=[e[0] for e in batch])
        self._capture_step_fp([e[0] for e in batch])
        return host_out

    def _run_batch_mixed(self, batch, pf) -> Tuple[torch.Tensor, torch.Tensor]:
        """Compute-thread body: ONE step advancing every pending decode lane
        AND one prefill chunk. The prefill lane rides the decode half at the
        idle sentinel, so its decode-side write drops."""
        st, take = pf
        expected = batch[0][4] if batch else st.generation
        if expected != self._generation or st.generation != self._generation:
            raise AllocationFailed("Lane pool was reset before this batched step ran")
        t_step = time.perf_counter()
        hidden, positions = self._lane_inputs(batch)
        chunk = st.hidden[:, st.offset : st.offset + take]
        out, chunk_out, _ = self.backend.paged_mixed_step(
            hidden, self._buffers(), positions, self._tables.copy(),
            chunk, st.lane, st.position, n_total=st.n_total,
        )
        host_out, host_chunk = out.cpu(), chunk_out.cpu()
        with self._reset_lock:
            if expected != self._generation:
                raise AllocationFailed("Lane pool was reset while this batched step ran")
        duration = time.perf_counter() - t_step
        tm.STEP_MIXED.observe(duration)
        tm.STEPS_MIXED.inc()
        tm.DECODE_TOKENS.inc(len(batch))
        self._count_step(batch, t_step, duration)
        self._ledger_account_step(duration, decode_lanes=[e[0] for e in batch], prefill=(st.lane, take))
        self._capture_step_fp([e[0] for e in batch], chunk_lane=st.lane)
        self.stats["mixed_steps"] += 1
        self.stats["prefill_tokens"] += take
        self.stats["max_prefill_tokens_per_step"] = max(
            self.stats["max_prefill_tokens_per_step"], take
        )
        st.compute_s += duration
        return host_out, host_chunk

    def _run_batch_gen(self, batch, gen_states) -> Tuple[torch.Tensor, np.ndarray]:
        """Compute-thread body: ONE generation step advancing every pending
        decode lane AND every generating lane (the client's leaves embed the
        generating lanes' tokens and sample every lane's next one on the
        device). Returns (out on the host, next tokens [n_lanes])."""
        expected = batch[0][4] if batch else next(iter(gen_states.values())).generation
        if expected != self._generation or any(st.generation != self._generation for st in gen_states.values()):
            raise AllocationFailed("Lane pool was reset before this batched step ran")
        t_step = time.perf_counter()
        hidden, positions = self._lane_inputs(batch)
        tokens = np.zeros((self.n_lanes,), np.int64)
        use_token = np.zeros((self.n_lanes,), bool)
        vecs = sampling_vectors(self.n_lanes, self.backend.cfg.vocab_size)
        vecs["u"] = np.zeros((self.n_lanes,), np.float32)
        for lane, st in gen_states.items():
            tokens[lane] = st.token
            use_token[lane] = True
            positions[lane] = st.position
            vecs["do_sample"][lane] = st.do_sample
            vecs["temperature"][lane] = st.temperature
            vecs["top_k"][lane] = st.top_k
            vecs["top_p"][lane] = st.top_p
            vecs["repetition_penalty"][lane] = st.repetition_penalty
            if st.uniforms is not None:
                vecs["u"][lane] = st.uniforms[len(st.collected) - 1]
            if st.seen is not None:
                vecs["seen_mask"][lane] = st.seen
        if self.page_size is not None:
            out, toks, _ = self.backend.paged_gen_decode_step(
                self.gen_params, hidden, tokens, use_token, self._buffers(), positions, self._tables.copy(),
                sampling_vecs=vecs,
            )
        else:
            out, toks, _ = self.backend.batched_gen_decode_step(
                self.gen_params, hidden, tokens, use_token, self._buffers(), positions, sampling_vecs=vecs,
            )
        host_out, host_toks = out.cpu(), toks.cpu().numpy()  # waits for the step on the device
        with self._reset_lock:
            if expected != self._generation:
                raise AllocationFailed("Lane pool was reset while this batched step ran")
        duration = time.perf_counter() - t_step
        tm.STEP_GEN.observe(duration)
        tm.STEPS_GEN.inc()
        tm.DECODE_TOKENS.inc(len(batch) + len(gen_states))
        self._count_step(batch, t_step, duration, n_gen=len(gen_states))
        self._ledger_account_step(duration, decode_lanes=[e[0] for e in batch], gen_lanes=list(gen_states))
        self._capture_step_fp([e[0] for e in batch] + list(gen_states))
        self.stats["gen_steps"] += 1
        self.stats["gen_lane_tokens"] += len(gen_states)
        self.stats["max_gen_lanes"] = max(self.stats["max_gen_lanes"], len(gen_states))
        for st in gen_states.values():
            if not st.started:
                st.started = True
                st.queue_s = max(t_step - st.enqueued, 0.0)
            st.compute_s += duration
        return host_out, host_toks

    def _run_batch_spec(self, spec_states: Dict[int, _LaneGenState]) -> Tuple[np.ndarray, np.ndarray]:
        """Compute-thread body of one speculative tick: the draft proposes
        k tokens a speculating lane, then ONE verify step feeds [last
        committed token, k drafts] at positions p..p+k and samples the
        target's token on every row; other lanes ride at the idle sentinel.
        Returns (g_hat [n_lanes, spec_k + 1], n_emit [n_lanes]) on the host;
        the event loop commits g_hat[lane, :n_emit[lane]].

        The ledger: the tick's whole wall (draft and verify) is billed over
        the speculating lanes through ``note_compute``, and each lane's share
        of the draft's wall rides beside it as ``draft_seconds``, with its
        proposed and accepted counts."""
        expected = next(iter(spec_states.values())).generation
        if expected != self._generation or any(st.generation != self._generation for st in spec_states.values()):
            raise AllocationFailed("Lane pool was reset before this batched step ran")
        if self._draft_warmed is not self.draft:
            # every bucket before the first measured tick: later lane mixes
            # never capture
            self.draft.warmup(self.n_lanes)
            self._draft_warmed = self.draft
        t_step = time.perf_counter()
        S = self.spec_k + 1
        contexts: List[Optional[List[int]]] = [None] * self.n_lanes
        for lane, st in spec_states.items():
            contexts[lane] = (st.context or []) + st.collected
        drafts = self.draft.propose(contexts)  # [n_lanes, spec_k] greedy
        draft_s = time.perf_counter() - t_step
        tokens = np.zeros((self.n_lanes, S), np.int64)
        positions = np.full((self.n_lanes,), self.max_length, np.int32)  # idle sentinel
        vecs = sampling_vectors(self.n_lanes, self.backend.cfg.vocab_size)
        vecs["u"] = np.zeros((self.n_lanes, S), np.float32)
        for lane, st in spec_states.items():
            tokens[lane, 0] = st.token
            tokens[lane, 1:] = drafts[lane]
            positions[lane] = st.position
            vecs["do_sample"][lane] = st.do_sample
            vecs["temperature"][lane] = st.temperature
            vecs["top_k"][lane] = st.top_k
            vecs["top_p"][lane] = st.top_p
            vecs["repetition_penalty"][lane] = st.repetition_penalty
            if st.uniforms is not None:
                # row j draws the stream's next draw plus j; remaining >= S
                # keeps them inside the stream's uniforms
                at = len(st.collected) - 1
                vecs["u"][lane] = st.uniforms[at : at + S]
            if st.seen is not None:
                vecs["seen_mask"][lane] = st.seen
        g_hat, n_emit, _ = self.backend.paged_spec_verify_step(
            self.gen_params, tokens, self._buffers(), positions, self._tables.copy(), sampling_vecs=vecs,
        )
        host_g, host_m = g_hat.cpu().numpy(), n_emit.cpu().numpy()  # waits for the step on the device
        with self._reset_lock:
            if expected != self._generation:
                raise AllocationFailed("Lane pool was reset while this batched step ran")
        n_spec = len(spec_states)
        emitted_total = int(sum(int(host_m[lane]) for lane in spec_states))
        duration = time.perf_counter() - t_step
        proposed_total = n_spec * self.spec_k
        tm.STEP_SPEC.observe(duration)
        tm.STEPS_SPEC.inc()
        tm.DECODE_TOKENS.inc(emitted_total)
        tm.SPEC_PROPOSED.inc(proposed_total)
        tm.SPEC_ACCEPTED.inc(emitted_total - n_spec)
        self._capture_step_fp(list(spec_states))
        self.stats.update(self.backend.step_program_stats())
        self.stats["batched_steps"] += 1
        self.stats["batched_tokens"] += emitted_total
        self.stats["spec_steps"] += 1
        self.stats["spec_proposed"] += proposed_total
        self.stats["spec_accepted"] += emitted_total - n_spec  # one bonus token a lane
        self.stats["max_spec_lanes"] = max(self.stats["max_spec_lanes"], n_spec)
        keys = []
        for lane in spec_states:
            key = self._ledger_keys.get(lane)
            if key is not None:
                keys.append(key)
                self._ledger.note_tokens(key, decode=int(host_m[lane]))
                self._ledger.note_spec(key, draft_seconds=draft_s / n_spec, proposed=self.spec_k,
                                       accepted=int(host_m[lane]) - 1)
        self._ledger.note_compute(keys, duration)
        for st in spec_states.values():
            if not st.started:
                st.started = True
                st.queue_s = max(t_step - st.enqueued, 0.0)
            st.compute_s += duration
        return host_g, host_m

    def _count_step(self, batch, t_step: float, duration: float, n_gen: int = 0) -> None:
        """Stats and the per-lane queue/compute split (compute thread)."""
        self.stats.update(self.backend.step_program_stats())
        self.stats["batched_steps"] += 1
        self.stats["batched_tokens"] += len(batch) + n_gen
        self.stats["max_batch"] = max(self.stats["max_batch"], len(batch) + n_gen)
        if batch:
            self.stats["decode_steps"] += 1
        for lane, *_ in batch:
            enq = self._enq_t.pop(lane, None)
            self._step_timing[lane] = {
                "queue_s": max(t_step - enq, 0.0) if enq is not None else 0.0,
                "compute_s": duration,
                "variant": "decode",
            }

    # ------------------------------------------------------- non-batchable ops

    def _new_temp(self) -> Optional[int]:
        """A synthetic mirror handle for a lane check-out under lockstep
        (None otherwise)."""
        return next(self._temp_ids) if self._lockstep else None

    def _release_temp(self, temp: Optional[int]) -> None:
        """Drop a check-out's mirror that will NOT be inserted back (a failed
        op, a read-only snapshot), or every worker keeps it."""
        if temp is None:
            return
        try:
            self.backend.release_temp(temp)
        except Exception as e:  # a degraded group dropped the mirrors with its workers
            logger.debug(f"releasing lockstep check-out {temp} failed: {e!r}")

    def _extract_lane(self, lane: int, temp: Optional[int] = None):
        """Compute-thread body: the lane as session-shaped [n_blocks, 1,
        max_length, hkv, d] buffers, so the functions that run on it need
        not know the mode: a dense lane's view of the pool (its address
        never changes, so its step programs stay valid), a paged lane
        gathered through its table row into a copy (a quantized pool
        decoded). Under lockstep (``temp``) every process checks its view
        out under the synthetic handle."""
        k_pool, v_pool = self._buffers()
        if temp is not None:
            return self.backend.lane_extract(k_pool, v_pool, lane, pool_handle=self._handles[0], temp_handle=temp)
        if self.page_size is not None:
            return self.backend.paged_lane_gather(k_pool, v_pool, self._tables[lane].copy())
        return self.backend.dense_lane_view(k_pool, v_pool, lane)

    def _insert_lane(self, lane: int, kv_lane, temp: Optional[int] = None) -> None:
        """Compute-thread body: the lane checked back IN, under the reset
        lock: a reset landing mid-way must never be followed by a write of
        pre-reset content into the zeroed pool. The lane check raises before
        anything is written. A dense lane was written in place (a failed
        chunk leaves only rows past the session's position, which nothing
        reads before they are written again); a paged lane's copy is
        scattered back and the programs that addressed it dropped."""
        k2, v2 = kv_lane
        with self._reset_lock:
            self._check_lane(lane)
            if temp is not None:
                self.backend.lane_insert(*self._buffers(), kv_lane, lane, pool_handle=self._handles[0],
                                         temp_handle=temp)
            elif self.page_size is not None:
                k_pool, v_pool = self._buffers()
                # unallocated (-1) slots drop: content past the session's
                # resident pages never lands anywhere
                self.backend.paged_lane_scatter(k_pool, v_pool, k2, v2, self._tables[lane].copy())
                self.backend.drop_cache_programs(kv_lane)

    async def run_exclusive(self, lane: int, fn: Callable, *, size: int = 0,
                            write_range: Optional[Tuple[int, int]] = None, extract: bool = True):
        """Run ``fn(kv_lane) -> (result, kv_lane')`` with the lane extracted
        into session-shaped buffers, then insert the updated lane back, all
        in ONE queue task (atomic with respect to batched steps). For any
        step the batched program does not cover. ``write_range=(t0, t1)``
        declares the token range the fn writes: paged mode allocates those
        pages first so the check-in has somewhere to land. ``extract=False``
        (a paged lane only) hands ``fn`` None: it builds the whole lane
        itself, which the check-in scatters (a seed, as petals_tpu's
        ``extract=False``)."""
        if not extract and self.page_size is None:
            raise ValueError("extract=False replaces a paged lane; a dense lane is written through its view")
        async with self._lane_busy(lane):
            self._check_lane(lane)
            if write_range is not None:
                await self.prepare_write(lane, int(write_range[0]), int(write_range[1]), timeout=self.alloc_timeout)
            # an exclusive op runs alone on the device: its whole wall bills
            # to this tenant, and a declared write range is prompt tokens
            ledger_key = self._ledger_keys.get(lane)
            if ledger_key is not None and write_range is not None:
                self._ledger.note_tokens(ledger_key, prefill=int(write_range[1]) - int(write_range[0]))

            def run():
                self._check_lane(lane)  # re-check: a reset may have raced the queue
                t_run = time.perf_counter()
                temp = self._new_temp()
                try:
                    result, kv_lane = fn(self._extract_lane(lane, temp) if extract else None)
                    self._insert_lane(lane, kv_lane, temp)
                except BaseException:
                    self._release_temp(temp)
                    raise
                if ledger_key is not None:
                    self._ledger.note_compute([ledger_key], time.perf_counter() - t_run)
                return result

            try:
                return await self.queue.submit(run, priority=PRIORITY_INFERENCE, size=size)
            except AllocationFailed:
                raise
            except BaseException as e:
                self._maybe_reset_pool(e)
                raise

    async def snapshot_lane(self, lane: int, position: int, b0: int, b1: int, *, return_device: bool = False):
        """Host copy of blocks [b0, b1) of a lane, rows [0, position): (k, v)
        each [b1 - b0, 1, position, hkv, d] on the CPU (a quantized pool's
        rows decoded, as ``paged_lane_gather`` decodes them). With
        ``return_device=True``: (k, v, k_dev, v_dev), the device pair the
        same rows as COPIES on the card (never views of the pool: a later
        step writes the lane in place). One queue task, so the copy is
        atomic with respect to the steps."""
        async with self._lane_busy(lane):
            self._check_lane(lane)

            def run():
                self._check_lane(lane)  # re-check: a reset may have raced the queue
                temp = self._new_temp()
                if temp is not None:
                    # a read-only check-out: the group's export, then the release
                    view = self._extract_lane(lane, temp)
                    try:
                        k, v = self.backend.export_kv(view, b0, b1, position)
                    finally:
                        self._release_temp(temp)
                    return (k, v, None, None) if return_device else (k, v)
                k, v = self._extract_lane(lane)
                kd, vd = k[b0:b1, :, :position].clone(), v[b0:b1, :, :position].clone()
                host = (kd.cpu(), vd.cpu())
                return (*host, kd, vd) if return_device else host

            return await self.queue.submit(run, priority=PRIORITY_INFERENCE, size=0)

    async def run_exclusive_chunks(self, lane: int, chunk_fns: Sequence[Callable], *, size: int = 0,
                                   write_range: Optional[Tuple[int, int]] = None) -> list:
        """Chunked-prefill interleaving: extract the lane once, run each
        ``fn(kv_lane) -> (result, kv_lane')`` as its OWN queue task, insert
        once. Between chunks the flush loop's batched decode steps run
        freely, so a long prefill does not stall every decoding session for
        its full length. Safe while checked out (a dense lane: while its
        view is being written): batched steps never write an idle-sentinel
        lane, nor read its rows. A failed chunk still checks the lane back in
        with the last consistent content (the session's position was not
        advanced)."""
        async with self._lane_busy(lane):
            self._check_lane(lane)
            if write_range is not None:
                await self.prepare_write(lane, int(write_range[0]), int(write_range[1]), timeout=self.alloc_timeout)
            ledger_key = self._ledger_keys.get(lane)
            if ledger_key is not None and write_range is not None:
                # the whole declared prompt bills once, here (the delegation
                # below declares no range)
                self._ledger.note_tokens(ledger_key, prefill=int(write_range[1]) - int(write_range[0]))
            if len(chunk_fns) == 1:
                # short prefills skip the separate extract / insert tasks
                return [await self.run_exclusive(lane, chunk_fns[0], size=size)]
            state = {}

            def extract():
                self._check_lane(lane)
                state["temp"] = self._new_temp()
                state["kv"] = self._extract_lane(lane, state["temp"])

            def insert():
                self._insert_lane(lane, state["kv"], state.get("temp"))  # checks the lane first

            try:
                await self.queue.submit(extract, priority=PRIORITY_INFERENCE, size=0)
            except BaseException:
                # a failure after the check-out's broadcast leaves the workers' mirror
                self._release_temp(state.get("temp"))
                raise
            results = []
            try:
                for fn in chunk_fns:
                    def run_chunk(fn=fn):
                        self._check_lane(lane)
                        t_run = time.perf_counter()
                        res, state["kv"] = fn(state["kv"])
                        self.stats["exclusive_chunks"] += 1
                        if ledger_key is not None:
                            self._ledger.note_compute([ledger_key], time.perf_counter() - t_run)
                        return res

                    try:
                        results.append(await self.queue.submit(run_chunk, priority=PRIORITY_INFERENCE, size=size))
                    except AllocationFailed:
                        raise
                    except BaseException as e:
                        self._maybe_reset_pool(e)
                        raise
            finally:
                if "kv" in state:
                    inserted = False
                    try:
                        await self.queue.submit(insert, priority=PRIORITY_INFERENCE, size=0)
                        inserted = True
                    except AllocationFailed:
                        pass  # lane invalidated mid-prefill: nothing to check in
                    except BaseException as e:
                        self._maybe_reset_pool(e)
                        raise
                    finally:
                        if not inserted:  # the workers' check-out is never consumed
                            self._release_temp(state.get("temp"))
            return results

    async def snapshot_from_swap(self, lane: int, position: int, b0: int, b1: int):
        """Host copy of a SUSPENDED lane's blocks [b0, b1), rows [0,
        position), read straight from its swap entry with no device work
        (``snapshot_lane`` would first swap the lane back in, spending pages
        and two copies to read bytes already on the host). Returns (k, v)
        shaped as ``snapshot_lane``'s host pair (a quantized entry decoded
        with ``dequantize_kv_np`` to float32), or None when the lane is not
        suspended, is busy, or its entry does not cover [0, position): the
        caller then takes the device path."""
        if self.page_size is None:
            return None
        slot = self._scheduler.lanes.get(lane)
        if slot is None:
            return None
        lock = self._lane_lock(lane)
        # a trylock: busy means a step or a resume is under way, and the
        # device path queues behind it correctly
        if not lock_try_acquire_nowait(lock):
            return None
        try:
            entry = slot.swap
            if entry is None or slot.suspending:
                return None
            ps = self.page_size
            n_slots = -(-position // ps)  # the table slots covering [0, position)
            index_of = {int(sl): i for i, sl in enumerate(entry.slots)}
            if any(sl not in index_of for sl in range(n_slots)):
                return None  # part of it was never resident: only the pool knows

            def assemble():
                quantized = isinstance(entry.k, PagedPool)
                hkv, d = entry.k.shape[-2], entry.k.shape[-1]
                out_dtype = torch.float32 if quantized else entry.k.dtype
                nb = b1 - b0
                k_out = torch.zeros((nb, 1, position, hkv, d), dtype=out_dtype)
                v_out = torch.zeros((nb, 1, position, hkv, d), dtype=out_dtype)
                for sl in range(n_slots):
                    i = index_of[sl]
                    t0, t1 = sl * ps, min((sl + 1) * ps, position)
                    for out, side in ((k_out, entry.k), (v_out, entry.v)):
                        if quantized:
                            rows = dequantize_kv_np(
                                side.codes[b0:b1, i, : t1 - t0].numpy(), side.scales[b0:b1, i, : t1 - t0].numpy(),
                                side.kind,
                            )
                            out[:, 0, t0:t1] = torch.from_numpy(rows)
                        else:
                            out[:, 0, t0:t1] = side[b0:b1, i, : t1 - t0]
                return k_out, v_out

            # the lane lock stays held across the copy, so a racing resume
            # cannot consume the entry mid-way; a trylock holds no order edge
            return await asyncio.to_thread(assemble)
        finally:
            lock.release()


def _log_crash(task: asyncio.Task) -> None:
    if not task.cancelled() and task.exception() is not None:
        logger.error("decode flush loop crashed", exc_info=task.exception())
