"""Request-scoped trace identity (the port's copy of
petals_tpu/telemetry/trace.py).

The client mints one ``trace_id`` per :class:`InferenceSession` and sends
it in the RPC open message; the server validates (or mints its own for old
clients) and threads it through admission → batcher → scheduler, so every
span and journal event a session touches carries the same id and the
session's whole life reconstructs as one causal timeline.

Propagation is a :mod:`contextvars` var within one task/thread (survives
awaits) plus EXPLICIT threading across boundaries the contextvar cannot
cross — the batcher's flush loop and the compute thread — where the id
rides on the scheduler's ``SessionSlot``.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
import uuid
from typing import Iterator, Optional

_TRACE_ID_RE = re.compile(r"^[0-9A-Za-z_-]{1,64}$")

_trace_id_var: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "petals_tpu_trace_id", default=None
)


def new_trace_id() -> str:
    """Mint a fresh 16-hex-char trace id (compact enough for span meta)."""
    return uuid.uuid4().hex[:16]


def normalize_trace_id(value) -> Optional[str]:
    """Validate a remote-supplied trace id: short url-safe token or None.
    Anything else is dropped (the server mints its own) — a peer must not
    be able to inject unbounded or unprintable bytes into spans/journals."""
    if not isinstance(value, str) or not _TRACE_ID_RE.match(value):
        return None
    return value


def current_trace_id() -> Optional[str]:
    return _trace_id_var.get()


def set_trace_id(trace_id: Optional[str]) -> contextvars.Token:
    """Set the current task/thread's trace id; returns the reset token."""
    return _trace_id_var.set(trace_id)


def reset_trace_id(token: contextvars.Token) -> None:
    """Best-effort reset: async-generator frames can resume under a
    different Context, where ``ContextVar.reset`` raises — clear instead."""
    try:
        _trace_id_var.reset(token)
    except ValueError:
        _trace_id_var.set(None)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str]) -> Iterator[Optional[str]]:
    token = _trace_id_var.set(trace_id)
    try:
        yield trace_id
    finally:
        reset_trace_id(token)


__all__ = [
    "current_trace_id",
    "new_trace_id",
    "normalize_trace_id",
    "reset_trace_id",
    "set_trace_id",
    "trace_context",
]
