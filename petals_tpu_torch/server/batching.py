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

- Dense mode (``page_size`` None or 0): the pool is [n_blocks, n_lanes,
  max_length, hkv, d] x2 and a lane is its row. Decode steps coalesce the
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

Not ported yet: speculative decoding (and its lanes), swap and
preemption, the ledger and fingerprints, multi-host lockstep (its mirrored
temp handles).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import itertools
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from petals_tpu_torch.data_structures import SESSION_PRIORITY_NORMAL
from petals_tpu_torch.ops.paged_attention import PagedPool, max_pages_for
from petals_tpu_torch.ops.sampling import sampling_vectors
from petals_tpu_torch.ops.threefry import uniform_for_draw
from petals_tpu_torch.server.memory_cache import AllocationFailed, MemoryCache, PageAllocator
from petals_tpu_torch.server.task_queue import PRIORITY_INFERENCE, PriorityTaskQueue

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
    enqueued: float = 0.0  # time.perf_counter() at admission
    queue_s: float = 0.0  # admission -> first chunk
    compute_s: float = 0.0  # summed mixed-step wall across chunks


@dataclasses.dataclass
class _LaneGenState:
    """One lane mid server-side generation: each tick's generation step
    feeds ``token`` at ``position`` and samples the next, until
    ``remaining`` reaches 0; then ``future`` resolves with ``collected``
    (petals_tpu/server/batching.py ``_LaneGenState`` without the
    speculative-decoding fields, A10)."""

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


@dataclasses.dataclass
class _LaneWaiter:
    """One parked acquire_lane caller, admitted by priority class then FIFO."""

    fut: asyncio.Future
    priority: int
    seq: int


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
    ):
        if page_size is not None and page_size < 0:
            raise ValueError(f"page_size must be >= 1, or 0 / None for the dense lane pool; got {page_size}")
        self.backend = backend
        self.memory_cache = memory_cache
        self.queue = queue
        self.n_lanes = n_lanes
        if page_size:
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
        self._pages: Optional[PageAllocator] = None
        self._tables: Optional[np.ndarray] = None  # [n_lanes, max_pages] int32, -1 = unallocated
        self._prefill_queue: List[_LanePrefillState] = []
        self._pool_stack: Optional[contextlib.AsyncExitStack] = None
        self._handles = None
        # bumped by a pool reset: every outstanding lane is invalidated
        self._generation = 0
        # makes the compute thread's post-step generation check atomic with
        # respect to a reset (check-then-act alone is a race)
        self._reset_lock = threading.Lock()
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
        self._flush_task: Optional[asyncio.Task] = None
        self._open_lock = asyncio.Lock()
        self._closed = False
        # graph_*: the backend's step programs (CUDA graphs on a card):
        # captures, replays, and captures after warm-up (anomalies)
        self.stats = {
            "batched_steps": 0, "batched_tokens": 0, "max_batch": 0,
            "gen_steps": 0, "gen_lane_tokens": 0, "max_gen_lanes": 0,
            "decode_steps": 0, "mixed_steps": 0, "prefill_tokens": 0,
            "max_prefill_tokens_per_step": 0, "pool_resets": 0, "exclusive_chunks": 0,
            "graph_captures": 0, "graph_replays": 0, "graph_anomalies": 0,
        }

    # ------------------------------------------------------------------ pool

    async def ensure_open(self, timeout: Optional[float] = None) -> None:
        """Reserve the pool on first use (budgeted through MemoryCache)."""
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
            self._pool_stack = stack
            self._handles = handles
            self._free_lanes = list(range(self.n_lanes))
            span = f"[{self.backend.first_block}, {self.backend.first_block + self.backend.n_blocks})"
            if self.page_size is None:
                logger.info(
                    f"Continuous-batching pool open: {self.n_lanes} lanes x "
                    f"{self.max_length} tokens for blocks {span}"
                )
                if self.backend.device.type == "cuda":
                    await self.queue.submit(
                        self.backend.warm_dense_programs, self._buffers(), self.n_lanes, self.max_length,
                        self.backend.longest_chunk(1), self.gen_params,
                    )
                return
            self._pages = PageAllocator(self.n_pages)
            self._tables = np.full((self.n_lanes, self.max_pages), -1, np.int32)
            logger.info(
                f"Paged-batching pool open: {self.n_pages} pages x {self.page_size} tokens "
                f"({self.n_lanes} lanes x {self.max_pages} table slots) for blocks {span}"
            )
            if self.backend.device.type == "cuda":
                # capture every step program on the open pool now, so that
                # serving replays and captures nothing
                await self.queue.submit(
                    self.backend.warm_step_programs, self._buffers(), self.n_lanes, self.max_pages,
                    self.max_chunk(), self.gen_params,
                )

    async def close(self) -> None:
        self._closed = True
        for w in self._lane_waiters:
            if not w.fut.done():
                w.fut.set_exception(AllocationFailed("Batcher is shutting down"))
        self._lane_waiters.clear()
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
        """The (k_pool, v_pool) pair every step consumes and mutates. A
        quantized pool rides as 4 buffers (codes x2, scales x2) and is
        wrapped back into a pair of PagedPools here."""
        bufs = self.memory_cache.get_buffers(*self._handles)
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
        """Lane and page occupancy, as a petals_tpu server announces it in
        ServerInfo.pool, so clients can route around a loaded server."""
        info = {
            "lanes": self.n_lanes,
            "busy_lanes": self.n_lanes - len(self._free_lanes) if self._handles is not None else 0,
            "lane_waiters": len(self._lane_waiters),
        }
        if self.page_size is not None:
            info["n_pages"] = self.n_pages
            info["pages_free"] = self._pages.n_free if self._pages is not None else self.n_pages
            info.update(self.pool_info())
        return info

    # ------------------------------------------------------------------ lanes

    async def acquire_lane(
        self, timeout: Optional[float] = None, *, priority: int = SESSION_PRIORITY_NORMAL
    ) -> int:
        """Borrow a lane; queues when all lanes are taken. Parked callers are
        admitted by priority class, then FIFO. Admission also claims the
        lane's first page. ``timeout`` bounds the whole acquisition,
        first-use pool allocation included."""
        lane = await self._acquire_lane(timeout=timeout, priority=priority)
        if self.page_size is None:
            return lane
        try:
            await self.prepare_write(lane, 0, 1, timeout=timeout)
        except BaseException:
            self.release_lane(lane)
            raise
        return lane

    async def _acquire_lane(self, timeout: Optional[float], priority: int) -> int:
        await self.ensure_open(timeout=timeout)
        if self._closed:
            raise AllocationFailed("Batcher is closed")
        if self._free_lanes:
            lane = self._free_lanes.pop(0)
            self._lane_generation[lane] = self._generation
            return lane
        waiter = _LaneWaiter(
            fut=asyncio.get_running_loop().create_future(),
            priority=int(priority), seq=next(self._waiter_seq),
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
        if self._tables is not None:
            row = self._tables[lane]
            for page in row[row >= 0]:
                self._pages.decref(int(page))
            row[:] = -1
        # hand straight to the best-placed waiter, else back to the free list;
        # the next session overwrites the lane from position 0, so no zeroing
        while self._lane_waiters:
            w = min(self._lane_waiters, key=lambda w: (w.priority, w.seq))
            self._lane_waiters.remove(w)
            if not w.fut.done():
                w.fut.set_result(lane)
                return
        self._free_lanes.append(lane)

    def _check_lane(self, lane: int) -> None:
        if self._lane_generation.get(lane) != self._generation:
            raise AllocationFailed(
                "Lane pool was reset after a failed device step: this session's "
                "KV is gone; the client must re-open the session"
            )

    def _occupancy(self) -> str:
        busy = self.n_lanes - len(self._free_lanes)
        if self.page_size is None:
            return f"{busy}/{self.n_lanes} lanes busy, {len(self._lane_waiters)} waiting"
        free_pages = self._pages.n_free if self._pages is not None else self.n_pages
        return (
            f"{busy}/{self.n_lanes} lanes busy, {free_pages}/{self.n_pages} pages free, "
            f"{len(self._lane_waiters)} waiting"
        )

    # ------------------------------------------------------------------ pages

    async def prepare_write(
        self, lane: int, t0: int, t1: int, timeout: Optional[float] = None
    ) -> None:
        """Make token range [t0, t1) of ``lane`` writable: allocate its
        missing pages, and fork every page it shares with the prefix cache
        or another lane (refs > 1) into a fresh copy. Waits on an exhausted
        pool until a page frees (release_lane, a prefix-cache eviction),
        raising AllocationFailed at ``timeout``. No-op in dense mode."""
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
        for slot in range(t0 // self.page_size, (t1 - 1) // self.page_size + 1):
            cur = int(self._tables[lane, slot])
            if cur >= 0 and alloc.refs[cur] == 1:
                continue  # already exclusively owned
            preferred = None if identity_base is None else identity_base + slot
            while True:
                page = alloc.try_alloc(preferred=preferred)
                if page is not None:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise AllocationFailed(
                        f"No free KV page within {timeout} s ({self._occupancy()})"
                    )
                alloc.freed_event.clear()
                try:
                    await asyncio.wait_for(alloc.freed_event.wait(), timeout=remaining)
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
            self._pages.incref(page)  # the refs belong to the caller (the prefix cache)
        return pages

    def unpin_pages(self, pages: Sequence[int], epoch: int) -> None:
        """Drop references taken by pin_lane_pages. Pins from an earlier
        epoch are ignored: the reset rebuilt the allocator, and those pages
        no longer exist to decref."""
        if self.page_size is None or self._pages is None or epoch != self._page_epoch:
            return
        for page in pages:
            self._pages.decref(int(page))

    def adopt_pages(self, lane: int, pages: Sequence[int]) -> None:
        """Point ``lane``'s first len(pages) table slots at resident (pinned)
        pages: a prefix-cache hit that copies ZERO bytes. The lane holds them
        shared; its first write into one forks it (prepare_write)."""
        if self.page_size is None or self._tables is None or len(pages) > self.max_pages:
            raise ValueError(f"cannot adopt {len(pages)} pages into a lane of {self.max_pages} slots")
        row = self._tables[lane]
        for slot, page in enumerate(pages):
            cur = int(row[slot])
            self._pages.incref(int(page))
            if cur >= 0:
                self._pages.decref(cur)
            row[slot] = int(page)

    # ------------------------------------------------------------------ steps

    async def step(self, lane: int, hidden: torch.Tensor, position: int) -> torch.Tensor:
        """One decode token for ``lane`` (hidden [1, 1, hidden]), coalesced
        with whatever other lanes are pending when the device is free.
        Returns [1, 1, hidden] on the host."""
        t_enq = time.perf_counter()
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
            pf = self._next_prefill_chunk(len(batch) + len(gen_states))
            if not batch and not gen_states and pf is None:
                continue
            try:
                toks = chunk_out = None
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
                else:
                    out = await self.queue.submit(
                        self._run_batch, batch, priority=PRIORITY_INFERENCE, size=len(batch)
                    )
            except BaseException as e:  # noqa: BLE001 — deliver to every waiter
                for *_, fut, _gen in batch:
                    if not fut.done():
                        fut.set_exception(e)
                for lane, st in gen_states.items():
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
                self._step_timing[lane] = {"queue_s": st.queue_s, "compute_s": st.compute_s, "variant": "gen"}
                if not st.future.done():
                    st.future.set_result(np.asarray([st.collected], np.int32))

    def max_chunk(self) -> int:
        """The longest chunk a mixed step can carry: the prefill budget, or
        one page when decode pressure lifts a smaller budget to a page
        (``_prefill_budget``), at most a lane. Page alignment only shortens
        a chunk."""
        return min(max(self.prefill_token_budget, self.page_size), self.max_length)

    def _prefill_budget(self, n_decode: int) -> int:
        """Per-tick fairness: the prefill token budget halves under decode
        pressure (more than half the lanes stepping), but never below one
        page, so prefills always progress and decode lanes never wait on
        more than one bounded chunk per tick."""
        budget = self.prefill_token_budget
        if n_decode > max(1, self.n_lanes // 2):
            budget = max(self.page_size, budget // 2)
        return budget

    def _next_prefill_chunk(self, n_decode: int) -> Optional[Tuple[_LanePrefillState, int]]:
        """The chunk riding this tick: the queue head's next ``take`` tokens,
        capped by the chunk cap and the budget, its END aligned to an
        absolute page boundary unless it is the prefill's last chunk.
        Returns (state, take) or None."""
        if not self._prefill_queue:
            return None
        st = self._prefill_queue[0]
        remaining = st.hidden.shape[1] - st.offset
        take = min(remaining, st.cap, self._prefill_budget(n_decode))
        if take < remaining:
            end = st.position + take
            aligned = end - end % self.page_size
            if aligned > st.position:
                take = aligned - st.position
        if st.offset == 0 and not st.outs:
            st.queue_s = max(time.perf_counter() - st.enqueued, 0.0)
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
        logger.warning(f"Pool step failed on the device ({error!r}): resetting the lane pool")
        with self._reset_lock:
            self._generation += 1
            self.stats["pool_resets"] += 1
            if self._pages is not None:
                self._pages.freed_event.set()  # wake waiters on the dead allocator
            if self.page_size is not None:
                # every table reference and pin died with the lanes: rebuild
                # the allocator and bump the epoch, so pins taken against the
                # old pool unpin as no-ops
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
        self._count_step(batch, t_step, duration)
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
            chunk, st.lane, st.position,
        )
        host_out, host_chunk = out.cpu(), chunk_out.cpu()
        with self._reset_lock:
            if expected != self._generation:
                raise AllocationFailed("Lane pool was reset while this batched step ran")
        duration = time.perf_counter() - t_step
        self._count_step(batch, t_step, duration)
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
        self._count_step(batch, t_step, duration, n_gen=len(gen_states))
        self.stats["gen_steps"] += 1
        self.stats["gen_lane_tokens"] += len(gen_states)
        self.stats["max_gen_lanes"] = max(self.stats["max_gen_lanes"], len(gen_states))
        for st in gen_states.values():
            if not st.started:
                st.started = True
                st.queue_s = max(t_step - st.enqueued, 0.0)
            st.compute_s += duration
        return host_out, host_toks

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

    def _extract_lane(self, lane: int):
        """Compute-thread body: the lane as session-shaped [n_blocks, 1,
        max_length, hkv, d] buffers, so the functions that run on it need
        not know the mode: a dense lane's view of the pool (its address
        never changes, so its step programs stay valid), a paged lane
        gathered through its table row into a copy (a quantized pool
        decoded)."""
        k_pool, v_pool = self._buffers()
        if self.page_size is not None:
            return self.backend.paged_lane_gather(k_pool, v_pool, self._tables[lane].copy())
        return self.backend.dense_lane_view(k_pool, v_pool, lane)

    def _insert_lane(self, lane: int, kv_lane) -> None:
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
            if self.page_size is not None:
                k_pool, v_pool = self._buffers()
                # unallocated (-1) slots drop: content past the session's
                # resident pages never lands anywhere
                self.backend.paged_lane_scatter(k_pool, v_pool, k2, v2, self._tables[lane].copy())
                self.backend.drop_cache_programs(kv_lane)

    async def run_exclusive(self, lane: int, fn: Callable, *, size: int = 0,
                            write_range: Optional[Tuple[int, int]] = None):
        """Run ``fn(kv_lane) -> (result, kv_lane')`` with the lane extracted
        into session-shaped buffers, then insert the updated lane back, all
        in ONE queue task (atomic with respect to batched steps). For any
        step the batched program does not cover. ``write_range=(t0, t1)``
        declares the token range the fn writes: paged mode allocates those
        pages first so the check-in has somewhere to land."""
        self._check_lane(lane)
        if write_range is not None:
            await self.prepare_write(lane, int(write_range[0]), int(write_range[1]), timeout=self.alloc_timeout)

        def run():
            self._check_lane(lane)  # re-check: a reset may have raced the queue
            result, kv_lane = fn(self._extract_lane(lane))
            self._insert_lane(lane, kv_lane)
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
        self._check_lane(lane)

        def run():
            self._check_lane(lane)  # re-check: a reset may have raced the queue
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
        self._check_lane(lane)
        if write_range is not None:
            await self.prepare_write(lane, int(write_range[0]), int(write_range[1]), timeout=self.alloc_timeout)
        if len(chunk_fns) == 1:
            # short prefills skip the separate extract / insert tasks
            return [await self.run_exclusive(lane, chunk_fns[0], size=size)]
        state = {}

        def extract():
            self._check_lane(lane)
            state["kv"] = self._extract_lane(lane)

        def insert():
            self._insert_lane(lane, state["kv"])  # checks the lane first

        await self.queue.submit(extract, priority=PRIORITY_INFERENCE, size=0)
        results = []
        try:
            for fn in chunk_fns:
                def run_chunk(fn=fn):
                    self._check_lane(lane)
                    res, state["kv"] = fn(state["kv"])
                    self.stats["exclusive_chunks"] += 1
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
                try:
                    await self.queue.submit(insert, priority=PRIORITY_INFERENCE, size=0)
                except AllocationFailed:
                    pass  # lane invalidated mid-prefill: nothing to check in
                except BaseException as e:
                    self._maybe_reset_pool(e)
                    raise
        return results


def _log_crash(task: asyncio.Task) -> None:
    if not task.cancelled() and task.exception() is not None:
        logger.error("decode flush loop crashed", exc_info=task.exception())
