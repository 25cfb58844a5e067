"""Asyncio helpers (petals_tpu/utils/asyncio_utils.py)."""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Awaitable, Callable, Optional, TypeVar

T = TypeVar("T")


def log_exception_callback(logger, what: str) -> Callable[["asyncio.Task"], None]:
    """Done-callback for fire-and-forget tasks: log the failure (with its
    traceback) that asyncio would otherwise only mention at GC time, if
    ever. Attach with ``task.add_done_callback(log_exception_callback(logger,
    "flush loop"))`` and keep a strong reference to the task: the loop holds
    tasks weakly."""

    def _callback(task: "asyncio.Task") -> None:
        if not task.cancelled() and task.exception() is not None:
            logger.warning(f"{what} failed", exc_info=task.exception())

    return _callback


async def shield_and_wait(task: Awaitable[T]) -> T:
    """Run ``task`` to completion even if the caller is cancelled; re-raise the
    cancellation afterwards. Prevents half-applied
    state transitions (e.g. a cache allocation that would leak its lock)."""
    inner = asyncio.ensure_future(task)
    cancel_exc: Optional[asyncio.CancelledError] = None
    while True:
        try:
            result = await asyncio.shield(inner)
            break
        except asyncio.CancelledError as e:
            if inner.cancelled():
                raise
            cancel_exc = e  # remember cancellation, let the inner task finish
    if cancel_exc is not None:
        raise cancel_exc
    return result


async def aiter_with_timeout(iterator: AsyncIterator[T], timeout: Optional[float]) -> AsyncIterator[T]:
    """Yield items from an async iterator, raising TimeoutError if the next item
    takes longer than ``timeout`` seconds."""
    while True:
        try:
            item = await asyncio.wait_for(iterator.__anext__(), timeout=timeout)
        except StopAsyncIteration:
            break
        yield item


async def as_aiter(*items: T) -> AsyncIterator[T]:
    for item in items:
        yield item


async def iter_as_aiter(iterable) -> AsyncIterator:
    for item in iterable:
        yield item


def anext_compat(ait):
    return ait.__anext__()
