"""Priority scheduling of compute onto the device (petals_tpu/server/
task_queue.py): a heap consumed by one worker thread. The worker runs each
step and returns only once its result is on the host, keeping exactly one
step in flight while the asyncio loop stays free for network I/O."""

from __future__ import annotations

import asyncio
import heapq
import itertools
import threading
from typing import Any, Callable, Optional

PRIORITY_INFERENCE = 1.0
PRIORITY_TRAINING = 2.0  # stateless forwards and probes: after every inference step
PRIORITY_BARRIER = 10.0  # quiesce sentinel: runs after everything pending (a lockstep span move)


class TaskRejected(Exception):
    """Raised by ``submit`` once the queue is shut down."""


class PriorityTaskQueue:
    """Submit callables with (priority, fifo) ordering; one worker thread runs them."""

    def __init__(self):
        self._heap: list = []
        self._counter = itertools.count()
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._shutdown = False

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("task queue already started")
        self._thread = threading.Thread(target=self._worker, name="ptt-compute", daemon=True)
        self._thread.start()

    async def submit(
        self, fn: Callable[..., Any], *args, priority: float = PRIORITY_INFERENCE, size: int = 0, **kwargs
    ) -> Any:
        """Run ``fn(*args, **kwargs)`` on the compute thread; lowest priority first."""
        loop = asyncio.get_running_loop()
        future: asyncio.Future = loop.create_future()

        def run():
            try:
                result = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — must cross the thread boundary
                loop.call_soon_threadsafe(_set_exc, future, e)
            else:
                loop.call_soon_threadsafe(_set_result, future, result)

        with self._cv:
            if self._shutdown:
                raise TaskRejected("Task queue is shut down")
            heapq.heappush(self._heap, (priority, next(self._counter), run))
            self._cv.notify()
        return await future

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                _, _, run = heapq.heappop(self._heap)
            run()

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)


def _set_result(future: asyncio.Future, result: Any) -> None:
    if not future.done():
        future.set_result(result)


def _set_exc(future: asyncio.Future, exc: BaseException) -> None:
    if not future.done():
        future.set_exception(exc)
