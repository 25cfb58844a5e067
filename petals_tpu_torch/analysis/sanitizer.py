"""Runtime concurrency sanitizer (opt-in: ``PETALS_TPU_SANITIZE=1``): the
port's copy of petals_tpu/analysis/sanitizer.py. The port's batcher builds
its locks through ``make_thread_lock`` / ``make_async_lock``, so the same
flag checks the port's lock order; its records are this module's own.

Two detectors, both zero-cost when disabled (the factories hand back a plain
``threading.Lock`` / an unwrapped ``AsyncTryLock``):

1. **Lock-order (AB/BA) cycles.** ``make_thread_lock(name)`` /
   ``make_async_lock(name)`` return wrappers that record, per execution
   context (thread or asyncio task, via contextvars), which locks are held
   when another is acquired. Holding A while acquiring B adds the edge A->B
   to a global graph; an acquisition whose new edge closes a cycle is
   reported with BOTH acquire-site stacks (this side and the recorded
   opposing edge), lockdep-style. Locks sharing one *name* form an
   equivalence class — all lane locks are "lane_lock" — so ordering inside a
   class is intentionally not checked (self-edges are skipped), and
   non-blocking try-acquires (``blocking=False`` / ``acquire_nowait``)
   record no incoming edge, matching lockdep's trylock exemption.

2. **Await while holding a thread lock.** ``SanitizingEventLoopPolicy``
   installs a task factory that wraps every task's coroutine in a trampoline
   calling ``note_suspension()`` after each yield: if the suspending context
   still holds a sanitized ``threading.Lock``, the event loop would stall
   every other task needing it — reported with the holder's acquire stack.

Typical test wiring (see tests/test_torch_scheduler.py)::

    asyncio.set_event_loop_policy(sanitizer.SanitizingEventLoopPolicy())
    sanitizer.get_sanitizer().reset()
    ... run ...
    assert not sanitizer.get_sanitizer().violations()
"""

from __future__ import annotations

import asyncio
import collections.abc
import contextvars
import dataclasses
import itertools
import logging
import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

from petals_tpu_torch.utils.locks import AsyncTryLock

logger = logging.getLogger(__name__)

_STACK_LIMIT = 12


def enabled() -> bool:
    return os.environ.get("PETALS_TPU_SANITIZE", "").strip().lower() not in (
        "",
        "0",
        "false",
        "off",
    )


# Held locks of the current execution context. contextvars give the right
# scope for both detectors: each thread has its own default context, and each
# asyncio task runs its steps in its own (copied) context. Stored as an
# immutable tuple so one task's update can never leak into another.
_held: contextvars.ContextVar[Tuple["_HeldLock", ...]] = contextvars.ContextVar(
    "petals_tpu_torch_sanitizer_held", default=()
)


_next_seq = itertools.count(1).__next__  # GIL-atomic unique ids for acquires


@dataclasses.dataclass(frozen=True)
class _HeldLock:
    name: str
    kind: str  # "thread" | "async"
    stack: str  # formatted acquire-site stack
    seq: int = 0  # unique per acquire: makes membership tests identity-like


@dataclasses.dataclass(frozen=True)
class _Edge:
    src: str
    dst: str
    src_stack: str  # where src was holding
    dst_stack: str  # where dst was acquired under src


def _capture_stack() -> str:
    return "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-2])


class LockOrderSanitizer:
    """Global acquisition-order graph + violation log (thread-safe)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()  # guards graph/violations, never sanitized
        self._edges: Dict[str, Dict[str, _Edge]] = {}
        self._violations: List[str] = []
        self._reported: set = set()
        # seqs of entries released from a context other than their acquirer's
        # (legal for threading.Lock); the acquirer's held-tuple is pruned of
        # them lazily, since its contextvar can't be written from here
        self._released_elsewhere: Set[int] = set()

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self._violations.clear()
            self._reported.clear()
            self._released_elsewhere.clear()

    def violations(self) -> List[str]:
        with self._mu:
            return list(self._violations)

    # ------------------------------------------------------------- recording

    def _prune_held(self) -> Tuple[_HeldLock, ...]:
        """Current context's held locks, minus entries whose lock was since
        released from another context (acquire on loop thread, release in an
        executor) — those would otherwise read as held-forever here."""
        held = _held.get()
        if held:
            with self._mu:
                if self._released_elsewhere:
                    live = tuple(
                        h for h in held if h.seq not in self._released_elsewhere
                    )
                    if len(live) != len(held):
                        self._released_elsewhere.difference_update(
                            h.seq for h in held
                        )
                        _held.set(live)
                        return live
        return held

    def note_acquire(self, name: str, kind: str, *, ordered: bool = True) -> _HeldLock:
        """Register a successful acquire in the current context; when
        ``ordered`` (a blocking acquire), add order edges from held locks."""
        stack = _capture_stack()
        entry = _HeldLock(name=name, kind=kind, stack=stack, seq=_next_seq())
        held = self._prune_held()
        if ordered:
            for h in held:
                if h.name != name:  # same name = equivalence class (lane locks)
                    self._add_edge(_Edge(h.name, name, h.stack, stack))
        _held.set(held + (entry,))
        return entry

    def note_release(self, entry: _HeldLock) -> None:
        held = self._prune_held()
        if entry in held:
            idx = len(held) - 1 - held[::-1].index(entry)
            _held.set(held[:idx] + held[idx + 1 :])
        else:
            # released from a different context than it was acquired in; mark
            # the seq so the acquirer's held-tuple is pruned at its next
            # note_acquire/note_suspension instead of reading held-forever
            with self._mu:
                self._released_elsewhere.add(entry.seq)

    def note_suspension(self) -> None:
        """Called by the task trampoline at every coroutine yield."""
        for h in self._prune_held():
            if h.kind != "thread":
                continue
            key = ("await-under-thread-lock", h.name)
            with self._mu:
                if key in self._reported:
                    continue
                self._reported.add(key)
                self._violations.append(
                    f"await while holding thread lock {h.name!r}: the event "
                    "loop cannot release it at the suspension point, so every "
                    "other user of the lock stalls.\n"
                    f"--- lock acquired at ---\n{h.stack}"
                    f"--- suspended at ---\n{_capture_stack()}"
                )

    # ------------------------------------------------------------ edge graph

    def _add_edge(self, edge: _Edge) -> None:
        with self._mu:
            dsts = self._edges.setdefault(edge.src, {})
            if edge.dst in dsts:
                return  # keep the first-seen stacks for this edge
            path = self._find_path(edge.dst, edge.src)
            dsts[edge.dst] = edge
            if path is None:
                return
            key = ("lock-order",) + tuple(sorted((edge.src, edge.dst)))
            if key in self._reported:
                return
            self._reported.add(key)
            lines = [
                f"lock-order cycle: acquiring {edge.dst!r} while holding "
                f"{edge.src!r}, but the opposite order "
                f"({' -> '.join([edge.dst] + [e.dst for e in path])}) was also "
                "observed — two contexts interleaving here deadlock.",
                f"--- this side: {edge.src!r} held at ---\n{edge.src_stack}",
                f"--- this side: {edge.dst!r} acquired at ---\n{edge.dst_stack}",
            ]
            for e in path:
                lines.append(
                    f"--- opposing edge {e.src!r} -> {e.dst!r}: {e.src!r} held at ---\n"
                    f"{e.src_stack}"
                    f"--- opposing edge: {e.dst!r} acquired at ---\n{e.dst_stack}"
                )
            self._violations.append("\n".join(lines))

    def _find_path(self, src: str, dst: str) -> Optional[List[_Edge]]:
        """Edge path src -> ... -> dst in the current graph (caller holds _mu)."""
        seen = {src}
        stack: List[Tuple[str, List[_Edge]]] = [(src, [])]
        while stack:
            node, path = stack.pop()
            for nxt, edge in self._edges.get(node, {}).items():
                if nxt == dst:
                    return path + [edge]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [edge]))
        return None


_SANITIZER = LockOrderSanitizer()


def get_sanitizer() -> LockOrderSanitizer:
    return _SANITIZER


# ------------------------------------------------------------ lock wrappers


class SanitizedThreadLock:
    """threading.Lock wrapper feeding the sanitizer. Non-reentrant."""

    def __init__(self, name: str):
        self._name = name
        self._lock = threading.Lock()
        # single holder at a time (non-reentrant); one slot means a release
        # from a thread other than the acquirer's (legal for threading.Lock)
        # still clears the right entry
        self._entry: Optional[_HeldLock] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            # timed/non-blocking acquires are trylocks: no incoming edges
            ordered = blocking and timeout == -1
            self._entry = _SANITIZER.note_acquire(
                self._name, "thread", ordered=ordered
            )
        return ok

    def release(self) -> None:
        entry, self._entry = self._entry, None
        self._lock.release()
        if entry is not None:
            _SANITIZER.note_release(entry)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "SanitizedThreadLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class SanitizedAsyncLock:
    """AsyncTryLock wrapper feeding the sanitizer."""

    def __init__(self, name: str):
        self._name = name
        self._lock = AsyncTryLock()
        self._entry: Optional[_HeldLock] = None  # single holder at a time

    async def acquire(self) -> bool:
        await self._lock.acquire()
        self._entry = _SANITIZER.note_acquire(self._name, "async")
        return True

    def acquire_nowait(self) -> bool:
        """Try-acquire without suspending (records no order edge). The inner
        AsyncTryLock refuses when held OR when a woken waiter is pending, so
        this can never co-own the lock with a blocking acquirer."""
        if not self._lock.acquire_nowait():
            return False
        self._entry = _SANITIZER.note_acquire(self._name, "async", ordered=False)
        return True

    def release(self) -> None:
        entry, self._entry = self._entry, None
        self._lock.release()
        if entry is not None:
            _SANITIZER.note_release(entry)

    def locked(self) -> bool:
        return self._lock.locked()

    async def __aenter__(self) -> "SanitizedAsyncLock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


def make_thread_lock(name: str):
    """A threading.Lock, sanitized when PETALS_TPU_SANITIZE is set."""
    return SanitizedThreadLock(name) if enabled() else threading.Lock()


def make_async_lock(name: str):
    """An AsyncTryLock (asyncio.Lock-compatible, safely try-lockable),
    sanitizer-wrapped when PETALS_TPU_SANITIZE is set."""
    return SanitizedAsyncLock(name) if enabled() else AsyncTryLock()


def lock_try_acquire_nowait(lock) -> bool:
    """Uniform non-blocking try-acquire for the locks ``make_async_lock``
    hands out (AsyncTryLock / SanitizedAsyncLock).

    Callers must be on the event loop with no await between their own
    ``locked()`` reasoning and this call (the check-and-take is atomic
    there). Sanitized locks record no lock-order edge for the trylock.

    A plain ``asyncio.Lock`` is rejected outright: its ``release()`` hands
    ownership to a woken waiter while ``locked()`` still reads False, so no
    outside trylock can be made safe without relying on CPython internals.
    """
    nowait = getattr(lock, "acquire_nowait", None)
    if nowait is None:
        raise TypeError(
            "lock_try_acquire_nowait needs an acquire_nowait()-capable lock "
            f"(AsyncTryLock / SanitizedAsyncLock), got {type(lock).__name__}"
        )
    return bool(nowait())


# --------------------------------------------------------- task trampoline


class _CoroShim:
    """Delegating coroutine wrapper: notifies the sanitizer at every yield
    (i.e. every point the wrapped task actually suspends)."""

    def __init__(self, coro):
        self._coro = coro
        # instance attrs (a class-level __qualname__ property is illegal):
        # keep asyncio's task reprs and debug helpers readable
        self.__name__ = getattr(coro, "__name__", "coro")
        self.__qualname__ = getattr(coro, "__qualname__", "coro")

    def send(self, value):
        result = self._coro.send(value)
        _SANITIZER.note_suspension()
        return result

    def throw(self, *exc_info):
        result = self._coro.throw(*exc_info)
        _SANITIZER.note_suspension()
        return result

    def close(self):
        return self._coro.close()

    def __iter__(self):
        return self

    def __next__(self):
        return self.send(None)

    def __await__(self):
        return self

    # keep asyncio/task reprs and debug helpers working
    @property
    def cr_code(self):
        return getattr(self._coro, "cr_code", None)

    @property
    def cr_frame(self):
        return getattr(self._coro, "cr_frame", None)

    @property
    def cr_running(self):
        return getattr(self._coro, "cr_running", False)

    @property
    def cr_await(self):
        return getattr(self._coro, "cr_await", None)


collections.abc.Coroutine.register(_CoroShim)


def _sanitizing_task_factory(loop, coro, **kwargs):
    if asyncio.iscoroutine(coro) and not isinstance(coro, _CoroShim):
        coro = _CoroShim(coro)
    return asyncio.Task(coro, loop=loop, **kwargs)


class SanitizingEventLoopPolicy(asyncio.DefaultEventLoopPolicy):
    """Event-loop policy whose loops wrap every task for the sanitizer."""

    def new_event_loop(self):
        loop = super().new_event_loop()
        loop.set_task_factory(_sanitizing_task_factory)
        return loop


__all__ = [
    "AsyncTryLock",
    "LockOrderSanitizer",
    "SanitizedAsyncLock",
    "SanitizedThreadLock",
    "SanitizingEventLoopPolicy",
    "enabled",
    "get_sanitizer",
    "lock_try_acquire_nowait",
    "make_async_lock",
    "make_thread_lock",
]
