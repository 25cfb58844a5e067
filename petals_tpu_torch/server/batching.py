"""Continuous batching over a paged KV pool: coalesce concurrent sessions'
decode tokens, and one prefill chunk, into one step per tick (the paged part
of petals_tpu/server/batching.py).

- One shared page pool [n_blocks, n_pages, page_size, hkv, d] x2, budgeted
  through MemoryCache once at open. Each session borrows a LANE for its
  lifetime and addresses the pool through its block-table row; lanes grow
  page by page (``prepare_write``), so admission costs one page.
- Every step runs over all lanes. Idle lanes ride at the sentinel position
  ``max_length``: their KV writes drop and their outputs are never read.
- A prefill is admitted with its whole page range allocated, then fed one
  page-aligned chunk per tick alongside the pending decode lanes (the mixed
  step), round-robin across admitted prefills under a per-tick token budget.

Steps run on the task queue's compute thread and mutate the pool IN PLACE.
A step that fails with a device error leaves the pool untrustworthy: the pool
is zeroed and the generation bumps, so every outstanding lane fails loudly on
its next step instead of decoding against lost KV. The generation is checked
before each step and again, under the reset lock, after it.

Not ported yet: server-side generation, speculative decoding, swap and
preemption, the prefix cache's shared pages, the ledger and fingerprints.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import itertools
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from petals_tpu_torch.data_structures import SESSION_PRIORITY_NORMAL
from petals_tpu_torch.ops.paged_attention import max_pages_for
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
class _LaneWaiter:
    """One parked acquire_lane caller, admitted by priority class then FIFO."""

    fut: asyncio.Future
    priority: int
    seq: int


class DecodeBatcher:
    """Shared paged-pool continuous batcher for one backend (one span)."""

    def __init__(
        self,
        backend,
        memory_cache: MemoryCache,
        queue: PriorityTaskQueue,
        *,
        n_lanes: int = 8,
        max_length: int = 1024,
        page_size: int = 64,
        n_pages: Optional[int] = None,  # default: n_lanes * max_pages (no oversubscription)
        prefill_token_budget: int = 512,  # max prefill-chunk tokens per mixed step
        alloc_timeout: Optional[float] = None,
    ):
        if page_size < 1:
            raise ValueError(f"the port serves the paged pool only: page_size must be >= 1, got {page_size}")
        self.backend = backend
        self.memory_cache = memory_cache
        self.queue = queue
        self.n_lanes = n_lanes
        self.page_size = int(page_size)
        # round the lane capacity UP to whole pages so tables tile exactly
        self.max_pages = max_pages_for(max_length, self.page_size)
        self.max_length = self.max_pages * self.page_size
        self.n_pages = int(n_pages) if n_pages else self.n_lanes * self.max_pages
        if self.n_pages < self.max_pages:
            raise ValueError(
                f"n_pages={self.n_pages} cannot hold even one full lane "
                f"({self.max_pages} pages of {self.page_size} tokens)"
            )
        self.prefill_token_budget = max(int(prefill_token_budget), 1)
        self.alloc_timeout = alloc_timeout
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
        self.stats = {
            "batched_steps": 0, "batched_tokens": 0, "max_batch": 0,
            "decode_steps": 0, "mixed_steps": 0, "prefill_tokens": 0,
            "max_prefill_tokens_per_step": 0, "pool_resets": 0,
        }

    # ------------------------------------------------------------------ pool

    async def ensure_open(self, timeout: Optional[float] = None) -> None:
        """Reserve the pool on first use (budgeted through MemoryCache)."""
        async with self._open_lock:
            if self._handles is not None or self._closed:
                return
            descs = self.backend.paged_cache_descriptors(
                self.n_pages, self.page_size, 0, self.backend.n_blocks
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
            self._pages = PageAllocator(self.n_pages)
            self._tables = np.full((self.n_lanes, self.max_pages), -1, np.int32)
            logger.info(
                f"Paged-batching pool open: {self.n_pages} pages x {self.page_size} tokens "
                f"({self.n_lanes} lanes x {self.max_pages} table slots) for blocks "
                f"[{self.backend.first_block}, {self.backend.first_block + self.backend.n_blocks})"
            )

    async def close(self) -> None:
        self._closed = True
        for w in self._lane_waiters:
            if not w.fut.done():
                w.fut.set_exception(AllocationFailed("Batcher is shutting down"))
        self._lane_waiters.clear()
        for pst in self._prefill_queue:
            if not pst.future.done():
                pst.future.set_exception(AllocationFailed("Batcher is shutting down"))
        self._prefill_queue.clear()
        if self._pool_stack is not None:
            await self._pool_stack.aclose()
            self._pool_stack = None
            self._handles = None

    def _buffers(self):
        """The (k_pool, v_pool) pair every step consumes and mutates."""
        return self.memory_cache.get_buffers(*self._handles)

    # ------------------------------------------------------------------ lanes

    async def acquire_lane(
        self, timeout: Optional[float] = None, *, priority: int = SESSION_PRIORITY_NORMAL
    ) -> int:
        """Borrow a lane; queues when all lanes are taken. Parked callers are
        admitted by priority class, then FIFO. Admission also claims the
        lane's first page. ``timeout`` bounds the whole acquisition,
        first-use pool allocation included."""
        lane = await self._acquire_lane(timeout=timeout, priority=priority)
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
        missing pages. Waits on an exhausted pool until a page frees
        (release_lane), raising AllocationFailed at ``timeout``."""
        if t1 <= t0:
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
            if self._tables[lane, slot] >= 0:
                continue
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
            self._tables[lane, slot] = page

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
        output for the whole range, [1, seq, hidden] on the host."""
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

    def pop_step_timing(self, lane: int) -> Optional[dict]:
        return self._step_timing.pop(lane, None)

    def _spawn_flush_loop(self) -> None:
        """(Re)start the flush loop unless it is already draining; the strong
        reference keeps the task alive and the callback surfaces a crash."""
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.create_task(self._flush_loop())
            self._flush_task.add_done_callback(_log_crash)

    async def _flush_loop(self) -> None:
        while self._pending or self._prefill_queue:
            batch, self._pending = self._pending, []
            # entries enqueued before a pool reset must fail loudly: running
            # them against the zeroed pool would silently corrupt their output
            stale = [e for e in batch if e[4] != self._generation]
            batch = [e for e in batch if e[4] == self._generation]
            for *_, fut, _gen in stale:
                if not fut.done():
                    fut.set_exception(AllocationFailed("Lane pool was reset while this step was pending"))
            for pst in [p for p in self._prefill_queue if p.generation != self._generation]:
                self._prefill_queue.remove(pst)
                if not pst.future.done():
                    pst.future.set_exception(
                        AllocationFailed("Lane pool was reset while this step was pending")
                    )
            pf = self._next_prefill_chunk(len(batch))
            if not batch and pf is None:
                continue
            try:
                chunk_out = None
                if pf is not None:
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
        # the tables are copied: the event loop may grow OTHER lanes while
        # this step runs, never slots this step reads or writes
        out, _ = self.backend.paged_decode_step(
            hidden, self._buffers(), positions, self._tables.copy()
        )
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

    def _count_step(self, batch, t_step: float, duration: float) -> None:
        """Stats and the per-lane queue/compute split (compute thread)."""
        self.stats["batched_steps"] += 1
        self.stats["batched_tokens"] += len(batch)
        self.stats["max_batch"] = max(self.stats["max_batch"], len(batch))
        if batch:
            self.stats["decode_steps"] += 1
        for lane, *_ in batch:
            enq = self._enq_t.pop(lane, None)
            self._step_timing[lane] = {
                "queue_s": max(t_step - enq, 0.0) if enq is not None else 0.0,
                "compute_s": duration,
                "variant": "decode",
            }


def _log_crash(task: asyncio.Task) -> None:
    if not task.cancelled() and task.exception() is not None:
        logger.error("decode flush loop crashed", exc_info=task.exception())
