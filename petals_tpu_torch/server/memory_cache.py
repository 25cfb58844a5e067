"""Server-wide KV-cache byte budget and the page allocator (the parts of
petals_tpu/server/memory_cache.py the paged pool uses).

- ``MemoryCache.allocate_cache(*descriptors, timeout=...)`` is an async
  context manager that reserves budget and yields integer handles; an
  oversubscribed request queues (FIFO) until space frees or the timeout
  elapses (``AllocationFailed``).
- ``get_buffers(*handles)`` gives the compute side its tensors, created as
  zeros on the descriptor's device at first use. A descriptor is budgeted
  by its real bytes, whatever its dtype: a quantized pool's int8/uint8 codes
  and float32 scales cost what they store, and their zeros decode to zeros. Buffers are mutated IN
  PLACE by the steps (where the JAX package donates and stores a new buffer),
  so there is no ``update_cache``.
- ``PageAllocator`` hands out page indices of one preallocated pool, with
  refcounts (a lane's table slot and a prefix-cache pin each hold one, and
  a page with ``refs > 1`` is copied before a write) and a ``freed_event``
  that wakes allocation waiters. It also reports the free list's runs
  (``fragmentation_info``, announced in ServerInfo.pool) and each lane's
  fractional page ownership (``fractional_shares``, the resource ledger's
  copy-on-write split).
- ``HostSwapPool`` budgets the host-RAM swap tier that preempted lanes and
  demoted prefix-cache nodes share, in wire bytes.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import logging
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from petals_tpu_torch import chaos
from petals_tpu_torch.data_structures import Handle

logger = logging.getLogger(__name__)


class AllocationFailed(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class TensorDescriptor:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def make_zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


class PageAllocator:
    """Page-grain free list + refcounts over ONE preallocated page pool.

    The batcher budgets its whole pool through MemoryCache once at open;
    this allocator then hands out page INDICES on demand, so admission costs
    one page and lanes grow page by page. Every mutation happens on the event
    loop; ``freed_event`` wakes allocation waiters when a page returns."""

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        self.n_pages = int(n_pages)
        self._free = collections.deque(range(self.n_pages))
        self._free_set = set(range(self.n_pages))
        self.refs = np.zeros((self.n_pages,), np.int32)
        self.freed_event = asyncio.Event()
        # petals_tpu's counters; ``forked`` counts copy-on-write forks
        self.stats = {"allocated": 0, "forked": 0, "freed": 0}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def try_alloc(self, preferred: Optional[int] = None) -> Optional[int]:
        """Take a free page (refs=1), or None when the pool is exhausted.
        ``preferred`` is taken when free: the batcher asks for the identity
        page so a lane's pages lie in sequential memory order."""
        if not self._free:
            return None
        if preferred is not None and preferred in self._free_set:
            self._free.remove(preferred)
            page = preferred
        else:
            page = self._free.popleft()
        self._free_set.discard(page)
        self.refs[page] = 1
        self.stats["allocated"] += 1
        return page

    def free_runs(self) -> list:
        """Lengths of the contiguous free-page runs, in ascending page order."""
        runs = []
        current = 0
        prev = -2
        for page in sorted(self._free_set):
            if page == prev + 1:
                current += 1
            else:
                if current:
                    runs.append(current)
                current = 1
            prev = page
        if current:
            runs.append(current)
        return runs

    def fragmentation_info(self) -> dict:
        """The free list's run-length histogram (fixed buckets), its largest
        run, and ``frag = 1 - largest_run / free`` (0: one hole)."""
        runs = self.free_runs()
        free = len(self._free_set)
        largest = max(runs) if runs else 0
        hist = {"1": 0, "2_3": 0, "4_7": 0, "8_15": 0, "16_plus": 0}
        for r in runs:
            if r == 1:
                hist["1"] += 1
            elif r <= 3:
                hist["2_3"] += 1
            elif r <= 7:
                hist["4_7"] += 1
            elif r <= 15:
                hist["8_15"] += 1
            else:
                hist["16_plus"] += 1
        return {
            "free": free,
            "runs": len(runs),
            "largest_run": largest,
            "frag": round(1.0 - largest / free, 4) if free else 0.0,
            "run_hist": hist,
        }

    def fractional_shares(self, tables: np.ndarray) -> np.ndarray:
        """Fractional page ownership per block-table row: a page with
        refcount R contributes 1/R to each row referencing it, so the rows'
        shares plus the prefix cache's pins sum to the allocated pages (the
        resource ledger's copy-on-write attribution). ``tables`` is
        [n_rows, max_pages] int32, -1 for an empty slot."""
        mask = tables >= 0
        pages = np.where(mask, tables, 0)
        inv = np.where(mask, 1.0 / np.maximum(self.refs[pages], 1), 0.0)
        return inv.sum(axis=1)

    def incref(self, page: int) -> None:
        if self.refs[page] <= 0:
            raise RuntimeError(f"incref of free page {page}")
        self.refs[page] += 1

    def decref(self, page: int) -> None:
        """Drop one reference; a page at zero returns to the free list (FIFO)
        and wakes allocation waiters."""
        if self.refs[page] <= 0:
            raise RuntimeError(f"decref of free page {page}")
        self.refs[page] -= 1
        if self.refs[page] == 0 and page not in self._free_set:
            self._free.append(page)
            self._free_set.add(page)
            self.stats["freed"] += 1
            self.freed_event.set()


class HostSwapPool:
    """Byte budget of the host-RAM KV swap tier.

    When the page pool is exhausted, the session scheduler
    (server/scheduler.py) preempts an idle victim lane: its resident pages
    are gathered on the device and copied to host memory, its pool pages
    freed, and the content scattered back onto (possibly other) pages when
    the session next steps. This class only counts the bytes, which are the
    pool's WIRE bytes (a quantized pool's codes and scales); the tensors
    ride in the scheduler's swap entries. ``try_reserve`` is
    all-or-nothing: a victim whose KV does not fit is not preemptable.

    The prefix cache's swapped tier shares this budget: its demoted nodes
    reserve with ``kind="cache"``, counted apart (``cache_bytes_in_use``),
    and the cache keeps to a fraction of the budget (prefix_cache.py
    ``CACHE_SWAP_FRAC``), so preemption always finds room.
    """

    def __init__(self, max_size_bytes: int):
        if max_size_bytes < 0:
            raise ValueError(f"max_size_bytes must be >= 0, got {max_size_bytes}")
        self.max_size_bytes = int(max_size_bytes)
        self._bytes_in_use = 0
        self._cache_bytes_in_use = 0  # of which: demoted prefix-cache nodes
        self.stats = {
            "reserved": 0, "rejected": 0, "peak_bytes": 0,
            "cache_reserved": 0, "cache_rejected": 0,
        }

    @property
    def bytes_in_use(self) -> int:
        return self._bytes_in_use

    @property
    def cache_bytes_in_use(self) -> int:
        return self._cache_bytes_in_use

    @property
    def bytes_left(self) -> int:
        return self.max_size_bytes - self._bytes_in_use

    def try_reserve(self, nbytes: int, kind: str = "session") -> bool:
        """Reserve ``nbytes`` for one swap entry, or False when it would
        overflow the budget. ``kind="cache"`` tags a prefix-cache demotion:
        the same budget, counted apart."""
        nbytes = int(nbytes)
        if nbytes < 0:
            raise ValueError(f"cannot reserve {nbytes} bytes")
        if chaos.ENABLED and chaos.fire(chaos.SITE_SWAP_RESERVE) is not None:
            # an injected pressure spike: exactly a full budget's answer
            self.stats["rejected" if kind == "session" else "cache_rejected"] += 1
            return False
        if nbytes > self.bytes_left:
            self.stats["rejected" if kind == "session" else "cache_rejected"] += 1
            return False
        self._bytes_in_use += nbytes
        if kind == "cache":
            self._cache_bytes_in_use += nbytes
            self.stats["cache_reserved"] += 1
        else:
            self.stats["reserved"] += 1
        self.stats["peak_bytes"] = max(self.stats["peak_bytes"], self._bytes_in_use)
        return True

    def free(self, nbytes: int, kind: str = "session") -> None:
        self._bytes_in_use -= int(nbytes)
        if kind == "cache":
            self._cache_bytes_in_use -= int(nbytes)
            if self._cache_bytes_in_use < 0:
                raise RuntimeError("cache swap accounting went negative")
        if self._bytes_in_use < 0:
            raise RuntimeError("swap-pool accounting went negative")


class MemoryCache:
    """Budgeted handle-based allocator for KV buffers on the device."""

    def __init__(self, max_size_bytes: Optional[int], max_alloc_timeout: Optional[float] = None):
        self.max_size_bytes = max_size_bytes if max_size_bytes is not None else 2**64
        self.max_alloc_timeout = max_alloc_timeout
        self._current_size_bytes = 0
        self._handle_counter = 0
        self._allocated: Dict[Handle, TensorDescriptor] = {}
        self._buffers: Dict[Handle, Optional[torch.Tensor]] = {}
        self._lock = asyncio.Lock()
        self._freed_event = asyncio.Event()
        self._waiter_queue: list = []  # FIFO fairness for oversubscribed allocs

    @property
    def bytes_left(self) -> int:
        return self.max_size_bytes - self._current_size_bytes

    @contextlib.asynccontextmanager
    async def allocate_cache(self, *descriptors: TensorDescriptor, timeout: Optional[float] = None):
        """Reserve budget for ``descriptors``; yield one handle per descriptor."""
        if self.max_alloc_timeout is not None:
            timeout = self.max_alloc_timeout if timeout is None else min(timeout, self.max_alloc_timeout)
        alloc_size = sum(d.nbytes for d in descriptors)
        if alloc_size > self.max_size_bytes:
            raise AllocationFailed(
                f"Cannot allocate {alloc_size} bytes: exceeds total cache size "
                f"{self.max_size_bytes} bytes"
            )
        alloc_task = asyncio.create_task(self._wait_and_reserve(descriptors, alloc_size, timeout))
        try:
            handles = await alloc_task
            yield handles
        finally:
            # cancellation while waiting aborts cleanly (nothing reserved yet);
            # if the reservation raced to completion anyway, free it here
            if not alloc_task.done():
                alloc_task.cancel()
                with contextlib.suppress(asyncio.CancelledError, AllocationFailed):
                    await alloc_task
            if alloc_task.done() and not alloc_task.cancelled() and alloc_task.exception() is None:
                self._free(alloc_task.result())

    async def _wait_and_reserve(
        self, descriptors: Sequence[TensorDescriptor], alloc_size: int, timeout: Optional[float]
    ) -> Tuple[Handle, ...]:
        start = time.monotonic()
        my_turn = object()  # this waiter's place in the FIFO
        self._waiter_queue.append(my_turn)
        try:
            while True:
                if self._waiter_queue[0] is my_turn:
                    async with self._lock:
                        if alloc_size <= self.bytes_left:
                            return self._reserve(descriptors, alloc_size)
                remaining = None if timeout is None else timeout - (time.monotonic() - start)
                if remaining is not None and remaining <= 0:
                    raise AllocationFailed(
                        f"Could not allocate {alloc_size} bytes within {timeout} s "
                        f"({self.bytes_left} of {self.max_size_bytes} bytes free, "
                        f"{len(self._waiter_queue) - 1} waiters ahead)"
                    )
                self._freed_event.clear()
                try:
                    await asyncio.wait_for(self._freed_event.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    pass  # loop once more to produce the AllocationFailed message
        finally:
            self._waiter_queue.remove(my_turn)
            self._freed_event.set()  # let the next waiter re-check its turn

    def _reserve(self, descriptors: Sequence[TensorDescriptor], alloc_size: int) -> Tuple[Handle, ...]:
        handles = []
        for descr in descriptors:
            handle = self._handle_counter
            self._handle_counter += 1
            self._allocated[handle] = descr
            self._buffers[handle] = None  # created at first get_buffers
            handles.append(handle)
        self._current_size_bytes += alloc_size
        logger.debug(f"Allocated {alloc_size} bytes, handles={handles}; left={self.bytes_left}")
        return tuple(handles)

    def _free(self, handles: Sequence[Handle]) -> None:
        freed = 0
        for handle in handles:
            descr = self._allocated.pop(handle, None)
            if descr is not None:
                freed += descr.nbytes
            self._buffers.pop(handle, None)  # drops the device tensor
        self._current_size_bytes -= freed
        self._freed_event.set()
        logger.debug(f"Freed {freed} bytes, handles={list(handles)}; left={self.bytes_left}")

    def get_buffers(self, *handles: Handle) -> list:
        """The device tensors for ``handles``, created as zeros on first use."""
        buffers = []
        for handle in handles:
            if handle not in self._allocated:
                raise KeyError(f"Handle {handle} was not allocated (or already freed)")
            if self._buffers[handle] is None:
                self._buffers[handle] = self._allocated[handle].make_zeros()
            buffers.append(self._buffers[handle])
        return buffers

    def reset_buffer(self, handle: Handle) -> None:
        """Zero a handle's buffer in place (recovery after a failed step)."""
        if handle not in self._allocated:
            raise KeyError(f"Handle {handle} was not allocated (or already freed)")
        if self._buffers[handle] is not None:
            self._buffers[handle].zero_()
