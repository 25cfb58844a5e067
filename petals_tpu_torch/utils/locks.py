"""Asyncio locks owned by this codebase (the port's copy of
petals_tpu/utils/locks.py).

``AsyncTryLock`` exists because ``asyncio.Lock`` cannot support a safe
non-blocking try-acquire from the outside: CPython's ``Lock.release()``
hands ownership to a woken waiter while ``locked()`` still reads ``False``
until that waiter's task actually resumes (the waiter sets ``_locked``
unconditionally once its wait-future resolves). A trylock that checks
``locked()`` in that window ends up co-owning the lock with the woken
waiter — broken mutual exclusion.

Here ``release()`` never transfers ownership: it clears the held flag and
wakes one waiter, which re-takes the lock when its task resumes. ``locked()``
is therefore always truthful, and ``acquire_nowait()`` is a plain
check-and-set, atomic on the event loop.
"""

from __future__ import annotations

import asyncio
import collections
from typing import Deque


class AsyncTryLock:
    """Non-reentrant asyncio mutex with a safe non-blocking ``acquire_nowait``.

    API-compatible with ``asyncio.Lock`` (``async with``, ``acquire``,
    ``release``, ``locked``), plus ``acquire_nowait()``. Blocking acquirers
    queue FIFO; ``acquire_nowait`` refuses while the lock is held OR while
    live waiters are queued, so it can never barge in front of (or co-own
    with) a waiter that ``release()`` has already woken.
    """

    def __init__(self) -> None:
        self._locked = False
        self._waiters: Deque[asyncio.Future] = collections.deque()

    def locked(self) -> bool:
        return self._locked

    def _has_live_waiters(self) -> bool:
        return any(not w.cancelled() for w in self._waiters)

    def acquire_nowait(self) -> bool:
        """Take the lock iff it is free with no live waiters; never suspends.

        A done-but-uncancelled waiter future counts as live: release() has
        already promised it the lock, even though ``locked()`` is False until
        its task resumes.
        """
        if self._locked or self._has_live_waiters():
            return False
        self._locked = True
        return True

    async def acquire(self) -> bool:
        if not self._locked and not self._has_live_waiters():
            self._locked = True
            return True
        loop = asyncio.get_running_loop()
        while True:
            fut = loop.create_future()
            self._waiters.append(fut)
            try:
                await fut
            except asyncio.CancelledError:
                # Woken and cancelled in the same beat: pass the wakeup we
                # consumed on to the next waiter, or it is lost and they
                # sleep forever over a free lock.
                if fut.done() and not fut.cancelled() and not self._locked:
                    self._wake_next()
                raise
            finally:
                try:
                    self._waiters.remove(fut)
                except ValueError:
                    pass
            if not self._locked:
                self._locked = True
                return True
            # lost the race to another acquirer that slipped in before our
            # task resumed: queue up again

    def release(self) -> None:
        if not self._locked:
            raise RuntimeError("Lock is not acquired.")
        self._locked = False
        self._wake_next()

    def _wake_next(self) -> None:
        for fut in self._waiters:
            if not fut.done():
                fut.set_result(True)
                return

    async def __aenter__(self) -> "AsyncTryLock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "locked" if self._locked else "unlocked"
        extra = f", waiters:{len(self._waiters)}" if self._waiters else ""
        return f"<AsyncTryLock {state}{extra}>"


__all__ = ["AsyncTryLock"]
