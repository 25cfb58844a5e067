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
  that wakes allocation waiters.
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
