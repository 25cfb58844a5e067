"""Closed-loop autoscaler controller: snapshot → policy → actuator.

The controller owns everything IMPURE around the pure policy: sampling
the swarm (a :class:`~petals_tpu_torch.utils.health.HealthMonitor`'s refreshed
state or any snapshot callable), journaling decisions into the telemetry
journal, exporting gauges, and dispatching decisions to an actuator.
Actuators are pluggable because what "spawn a replica" means differs by
deployment: ``server_actuator`` resizes in-process port Servers, the CLI
shells out to operator-provided commands (or just journals in advisory
mode).

An actuator failure is journaled and COUNTED but never re-raised into
the control loop — a failed spawn must not kill the controller that
would retry after the cooldown.
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Awaitable, Callable, List, Optional, Tuple, Union

from petals_tpu_torch.swarm.policy import AutoscalerPolicy, Decision, PolicyConfig, SwarmSnapshot
from petals_tpu_torch.telemetry import get_journal
from petals_tpu_torch.telemetry import instruments as tm
from petals_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# a callback may be sync or async; the controller awaits either
_MaybeAsync = Union[Callable[..., Awaitable[object]], Callable[..., object]]


async def _invoke(fn: _MaybeAsync, *args) -> object:
    result = fn(*args)
    if inspect.isawaitable(result):
        result = await result
    return result


def _accepts_n_args(fn, n: int) -> bool:
    """Whether ``fn`` can be called with ``n`` positional args — used to
    pass the decision's phase tier to scale_out callbacks that declare a
    second parameter, without breaking single-arg legacy callbacks."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    count = 0
    for p in sig.parameters.values():
        if p.kind is p.VAR_POSITIONAL:
            return True
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            count += 1
    return count >= n


class CallbackActuator:
    """Dispatch decisions to per-action callbacks (sync or async).

    ``scale_out(span)`` / ``scale_in(peer)`` / ``resize(peer, span)``;
    a missing callback makes that action advisory (journaled, not acted
    on). Returns whether the action was actually performed."""

    def __init__(
        self,
        *,
        scale_out: Optional[_MaybeAsync] = None,
        scale_in: Optional[_MaybeAsync] = None,
        resize: Optional[_MaybeAsync] = None,
    ):
        self._callbacks = {"scale_out": scale_out, "scale_in": scale_in, "resize": resize}

    async def apply(self, decision: Decision) -> bool:
        fn = self._callbacks.get(decision.action)
        if fn is None:
            return False
        if decision.action == "scale_out":
            tier = getattr(decision, "tier", None)
            if tier is not None and _accepts_n_args(fn, 2):
                # tier-aware spawners boot the replica with --phase_tier
                await _invoke(fn, decision.span, tier)
            else:
                await _invoke(fn, decision.span)
        elif decision.action == "scale_in":
            await _invoke(fn, decision.target)
        else:
            await _invoke(fn, decision.target, decision.span)
        return True


def server_actuator(servers) -> CallbackActuator:
    """An in-process actuator over this process's port servers: a resize
    decision moves the named server's span with ``Server.resize`` (its live
    sessions pushed to replicas first); scale-out and scale-in stay
    advisory, as there is no process to start or stop here. ``servers`` is
    a list, read at each decision, so servers added later are found."""

    async def resize(peer: str, span) -> None:
        by_peer = {s.identity.peer_id.to_string(): s for s in servers if s.identity is not None}
        if peer not in by_peer:
            raise KeyError(f"no server of this process is peer {peer!r}")
        await by_peer[peer].resize(int(span[0]))

    return CallbackActuator(resize=resize)


class Autoscaler:
    """Drives the policy: one :meth:`step` per snapshot, or :meth:`run`
    to loop against a snapshot source on a fixed period."""

    def __init__(
        self,
        snapshot_fn: Optional[_MaybeAsync] = None,
        *,
        actuator: Optional[CallbackActuator] = None,
        config: Optional[PolicyConfig] = None,
        interval_s: float = 5.0,
    ):
        self.policy = AutoscalerPolicy(config)
        self.actuator = actuator
        self.snapshot_fn = snapshot_fn  # tick:int -> SwarmSnapshot (sync or async)
        self.interval_s = interval_s
        self.tick = 0
        self.decisions: List[Decision] = []
        # (decision, applied) pairs — what the actuator actually did
        self.applied: List[Tuple[Decision, bool]] = []

    async def step(self, snapshot: SwarmSnapshot) -> List[Decision]:
        """Feed one snapshot through the policy; journal + act on the
        decisions. The journal event carries the full evidence so an
        operator can answer "why did it scale?" from telemetry alone."""
        decisions = self.policy.observe(snapshot)
        tm.AUTOSCALE_HOT_STREAK.set(self.policy._hot_streak)
        tm.AUTOSCALE_REPLICAS.set(snapshot.replica_count())
        for decision in decisions:
            tm.AUTOSCALE_DECISIONS.labels(action=decision.action).inc()
            entry = decision.to_journal()
            get_journal().event("autoscale_decision", **entry)
            logger.info(
                f"autoscale[{decision.tick}] {decision.action} "
                f"target={decision.target} span={decision.span}: {decision.reason}"
            )
            self.decisions.append(decision)
            applied = False
            if self.actuator is not None:
                try:
                    applied = bool(await self.actuator.apply(decision))
                except Exception as e:
                    tm.AUTOSCALE_APPLY_FAILED.inc()
                    get_journal().event(
                        "autoscale_apply_failed",
                        action=decision.action,
                        target=decision.target,
                        error=repr(e),
                    )
                    logger.warning(
                        f"autoscale actuator failed for {decision.action}: {e!r}"
                    )
                else:
                    if applied:
                        get_journal().event(
                            "autoscale_applied",
                            action=decision.action,
                            target=decision.target,
                            span=list(decision.span) if decision.span else None,
                        )
            self.applied.append((decision, applied))
        return decisions

    async def run_once(self) -> List[Decision]:
        """Sample the snapshot source once and step the policy."""
        if self.snapshot_fn is None:
            raise RuntimeError("Autoscaler.run_once needs a snapshot_fn")
        snapshot = await _invoke(self.snapshot_fn, self.tick)
        self.tick += 1
        if snapshot is None:
            return []
        return await self.step(snapshot)

    async def run(self, *, max_ticks: Optional[int] = None) -> None:
        """Control loop: sample every ``interval_s`` until cancelled (or
        ``max_ticks`` ticks, for tests)."""
        while max_ticks is None or self.tick < max_ticks:
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a failed sample (DHT timeout, chaos-dropped lookup) skips
                # the tick; the controller must outlive transient failures
                logger.warning(f"autoscale tick {self.tick} failed: {e!r}")
                self.tick += 1
            await asyncio.sleep(self.interval_s)
