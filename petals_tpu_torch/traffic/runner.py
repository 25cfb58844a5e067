"""Open-loop schedule replay: thread per session, arrivals never wait.

An open-loop driver is the honest way to load-test a serving system:
closed-loop drivers (next request after the previous reply) slow down
exactly when the system does, hiding queueing collapse. Here each
:class:`~petals_tpu_torch.traffic.generator.SessionPlan` fires at its
scheduled offset regardless of how the earlier sessions are doing — a
slow swarm accumulates concurrent sessions, like real users would.

``session_fn`` runs in the session's own thread and does the actual
client work (open a session, generate, return whatever the caller wants
recorded). Exceptions are captured per-session, never lost: a "lost
session" gate is only meaningful if every failure is accounted for.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from petals_tpu_torch.traffic.generator import SessionPlan
from petals_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["SessionResult", "run_schedule"]


@dataclasses.dataclass
class SessionResult:
    index: int
    tenant: int
    ok: bool
    value: Any = None  # whatever session_fn returned
    error: Optional[str] = None
    started_at: float = 0.0  # offset from run start (s)
    elapsed_s: float = 0.0


def run_schedule(
    plans: Sequence[SessionPlan],
    session_fn: Callable[[SessionPlan], Any],
    *,
    time_scale: float = 1.0,
    join_timeout_s: float = 300.0,
) -> List[SessionResult]:
    """Replay ``plans`` open-loop; returns one result per plan, in plan
    order. ``time_scale`` compresses the schedule (0.5 = twice as fast)
    so a 60 s "day" can run in a 30 s CI budget without changing the
    schedule itself (and hence the seeded determinism)."""
    results: List[Optional[SessionResult]] = [None] * len(plans)
    t0 = time.monotonic()

    def _one(plan: SessionPlan) -> None:
        start = time.monotonic()
        result = SessionResult(
            index=plan.index, tenant=plan.tenant, ok=False, started_at=start - t0
        )
        try:
            result.value = session_fn(plan)
            result.ok = True
        except Exception as e:  # captured per-session: the gate counts these
            result.error = repr(e)
            logger.warning(f"traffic session {plan.index} failed: {e!r}")
        result.elapsed_s = time.monotonic() - start
        results[plan.index] = result

    threads: List[threading.Thread] = []
    for plan in plans:
        target_t = t0 + plan.t * time_scale
        delay = target_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        thread = threading.Thread(
            target=_one, args=(plan,), name=f"traffic-{plan.index}", daemon=True
        )
        thread.start()
        threads.append(thread)

    deadline = time.monotonic() + join_timeout_s
    for thread in threads:
        thread.join(max(0.0, deadline - time.monotonic()))
    for plan, thread in zip(plans, threads):
        if thread.is_alive() and results[plan.index] is None:
            results[plan.index] = SessionResult(
                index=plan.index, tenant=plan.tenant, ok=False,
                error="timeout: session still running at join deadline",
                started_at=plan.t * time_scale,
                elapsed_s=join_timeout_s,
            )
    # every slot is filled by construction; the assert documents the invariant
    assert all(r is not None for r in results)
    return [r for r in results if r is not None]
