"""Deterministic fault-injection plane for swarm chaos testing.

Petals' promise is serving on an unreliable public swarm; hand-picked
failure tests only exercise the failure modes someone thought of. This
plane injects faults at NAMED SITES wired into the production code paths
— RPC calls, mid-stream receives, the handler's step boundary, the
migration push, DHT announces and lookups, the swap-pool budget — under
a seeded RNG, so a chaos run is
reproducible: the same seed and call order yields the same fault
sequence. It is petals_tpu's plane (petals_tpu/chaos/plane.py): the same
spec and seed give the same decisions, the same log and the same
corruption, so a mixed swarm of both packages' servers can share one run.

Zero overhead when disabled: every call site guards with
``if chaos.ENABLED:`` (a module attribute read) before touching the
plane, and ``ENABLED`` is False unless ``PETALS_TPU_CHAOS`` is set or a
test calls :func:`configure`.

Env spec (``PETALS_TPU_CHAOS``): semicolon-separated tokens, e.g.::

    PETALS_TPU_CHAOS="seed=42;rpc.call:drop:0.1;handler.step:delay:0.2:0.05"

- ``seed=N`` seeds the RNG (default 0).
- ``site:action[:p[:delay_s[:max_count]]]`` adds a rule: at ``site``,
  with probability ``p`` (default 1.0), apply ``action`` — ``drop`` /
  ``refuse`` raise :class:`ChaosInjected`, ``delay`` sleeps ``delay_s``
  seconds, ``kill`` invokes the registered kill callback (an in-process
  stand-in for a mid-step server death) then raises. ``max_count``
  bounds how many times the rule may fire.

A malformed spec raises at import — a typo'd chaos run silently testing
nothing would be worse than a crash.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Callable, List, Optional, Sequence

from petals_tpu_torch.analysis.sanitizer import make_thread_lock
from petals_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Named injection sites. Static, code-defined strings: they label the
# petals_chaos_injections_total metric (bounded cardinality) and the
# chaos log, and typos in a rule's site are rejected at parse time.
SITE_RPC_CALL = "rpc.call"  # client unary call (detail: method name)
SITE_RPC_STREAM = "rpc.stream_open"  # client stream open (detail: method)
SITE_RPC_STREAM_RECV = "rpc.stream_recv"  # client mid-stream receive (detail: method)
SITE_HANDLER_STEP = "handler.step"  # server inference-step boundary
SITE_MIGRATE_PUSH = "migrate.push"  # server->server session_migrate push
SITE_HANDOFF_PUSH = "handoff.push"  # prefill->decode KV handoff push (disagg)
SITE_ANNOUNCE = "dht.announce"  # server's periodic DHT announce
SITE_DHT_LOOKUP = "dht.lookup"  # client route discovery (module-info fetch)
SITE_SWAP_RESERVE = "swap.reserve"  # host swap-pool budget reservation
SITE_INTEGRITY_CORRUPT = "integrity.corrupt"  # server activation corruption (detail: peer/session)

SITES = (
    SITE_RPC_CALL,
    SITE_RPC_STREAM,
    SITE_RPC_STREAM_RECV,
    SITE_HANDLER_STEP,
    SITE_MIGRATE_PUSH,
    SITE_HANDOFF_PUSH,
    SITE_ANNOUNCE,
    SITE_DHT_LOOKUP,
    SITE_SWAP_RESERVE,
    SITE_INTEGRITY_CORRUPT,
)

ACTIONS = ("drop", "delay", "refuse", "kill", "corrupt")

MAX_LOG = 1024  # bounded injection log (tests assert against it)


class ChaosInjected(RuntimeError):
    """A fault injected by the chaos plane (drop/refuse/kill)."""


@dataclasses.dataclass
class ChaosRule:
    """One fault rule: at ``site``, with probability ``p``, do ``action``.

    ``match`` (programmatic only) restricts the rule to arrivals whose
    detail string contains it — e.g. only ``ptu.push`` RPC calls.
    ``max_count`` caps total firings; ``count`` tracks them."""

    site: str
    action: str
    p: float = 1.0
    delay_s: float = 0.0
    match: Optional[str] = None
    max_count: Optional[int] = None
    count: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r} (known: {SITES})")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r} (known: {ACTIONS})")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"chaos probability must be in [0, 1], got {self.p}")
        if self.delay_s < 0:
            raise ValueError(f"chaos delay must be >= 0, got {self.delay_s}")


class ChaosPlane:
    """Seeded rule engine. One shared RNG consumes a draw per matching
    arrival, so a fixed seed + fixed call order reproduces the same fault
    sequence (concurrent swarms interleave arrivals nondeterministically;
    tests that need exactness keep the perturbed path single-threaded)."""

    def __init__(
        self,
        seed: int = 0,
        rules: Sequence[ChaosRule] = (),
        kill_callback: Optional[Callable[[str, Optional[str]], None]] = None,
    ):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self.rules: List[ChaosRule] = list(rules)
        self.kill_callback = kill_callback
        self._lock = make_thread_lock("chaos.plane")
        self.log: List[dict] = []  # fired injections, bounded to MAX_LOG

    def decide(self, site: str, detail: Optional[str] = None) -> Optional[ChaosRule]:
        """One arrival at ``site``: the first matching rule that passes its
        probability draw fires (and is logged + counted); None otherwise."""
        with self._lock:
            for rule in self.rules:
                if rule.site != site:
                    continue
                if rule.match is not None and (
                    detail is None or rule.match not in str(detail)
                ):
                    continue
                if rule.max_count is not None and rule.count >= rule.max_count:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.count += 1
                if len(self.log) < MAX_LOG:
                    self.log.append(
                        {"site": site, "action": rule.action, "detail": detail}
                    )
                from petals_tpu_torch.telemetry import instruments as tm

                tm.CHAOS_INJECTIONS.labels(site=site, action=rule.action).inc()
                return rule
        return None

    def fired(self, site: Optional[str] = None) -> List[dict]:
        with self._lock:
            entries = list(self.log)
        if site is not None:
            entries = [e for e in entries if e["site"] == site]
        return entries


# ----------------------------------------------------------------- module API
#
# Call sites read `ENABLED` first (one attribute load — the disabled-path
# cost), then go through inject()/fire(). configure()/disable() swap the
# module-level plane; the env spec arms it at import time.

ENABLED: bool = False
_plane: Optional[ChaosPlane] = None


def configure(
    seed: int = 0,
    rules: Sequence[ChaosRule] = (),
    kill_callback: Optional[Callable[[str, Optional[str]], None]] = None,
) -> ChaosPlane:
    """Arm the chaos plane (tests/benchmarks call this programmatically)."""
    global _plane, ENABLED
    _plane = ChaosPlane(seed=seed, rules=rules, kill_callback=kill_callback)
    ENABLED = True
    logger.warning(
        f"CHAOS PLANE ARMED (seed={seed}, {len(_plane.rules)} rule(s)) — "
        "faults will be injected into production code paths"
    )
    return _plane


def disable() -> None:
    global _plane, ENABLED
    _plane = None
    ENABLED = False


def get_plane() -> Optional[ChaosPlane]:
    return _plane


def fire(site: str, detail: Optional[str] = None) -> Optional[str]:
    """Synchronous decision: the action name that fired at ``site``, or
    None. For sync sites that interpret the action themselves —
    ``swap.reserve`` treats any firing as a budget refusal, and
    ``dht.announce`` treats any firing as a lost announce."""
    plane = _plane
    if plane is None:
        return None
    rule = plane.decide(site, detail)
    return rule.action if rule is not None else None


async def inject(site: str, detail: Optional[str] = None) -> None:
    """Async injection with full action semantics: ``delay`` sleeps,
    ``drop``/``refuse`` raise :class:`ChaosInjected`, ``kill`` invokes the
    plane's kill callback (in-process stand-in for a server death) and
    then raises."""
    plane = _plane
    if plane is None:
        return
    rule = plane.decide(site, detail)
    if rule is None:
        return
    if rule.action == "delay":
        await asyncio.sleep(rule.delay_s)
        return
    if rule.action == "kill" and plane.kill_callback is not None:
        plane.kill_callback(site, detail)
    raise ChaosInjected(f"chaos[{site}]: {rule.action} ({detail or 'no detail'})")


def _flip_indices(width: int, site_seed: int, position: int) -> list:
    """The components ``corrupt_array`` flips in a row of ``width``."""
    plane = _plane
    base = plane.seed if plane is not None else 0
    rng = random.Random((base << 20) ^ (int(site_seed) & 0xFFFFF) ^ int(position))
    return rng.sample(range(width), max(1, width // 8))


def corrupt_array(arr, site_seed: int, position: int = 0):
    """Seeded activation corruption for ``integrity.corrupt``: perturb the
    LAST token row of ``arr [batch, seq, hidden]`` (a numpy array, or a
    tensor on the host after the device-to-host copy) by sign-flipping a
    deterministic subset of components — the in-process stand-in for a
    faulty/malicious replica returning plausible-but-wrong activations
    (magnitudes stay realistic, so nothing downstream NaNs or clips; only
    the fingerprint plane can tell). Deterministic in ``(plane seed,
    site_seed, position)`` so a chaos run reproduces bit-for-bit; a sign
    flip is exact in every dtype, so a bfloat16 tensor's flipped row is
    petals_tpu's."""
    import numpy as np
    import torch

    idx = _flip_indices(arr.shape[-1], site_seed, position)
    if isinstance(arr, torch.Tensor):
        out = arr.clone()
        out[0, -1, idx] = -out[0, -1, idx]
        return out
    out = np.array(arr, copy=True)
    row = out[0, -1, :]
    row[idx] = -row[idx]
    out[0, -1, :] = row
    return out


def parse_spec(spec: str) -> tuple:
    """Parse a ``PETALS_TPU_CHAOS`` spec into ``(seed, rules)``."""
    seed = 0
    rules: List[ChaosRule] = []
    for token in spec.split(";"):
        token = token.strip()
        if not token:
            continue
        if token.startswith("seed="):
            seed = int(token[len("seed="):])
            continue
        parts = token.split(":")
        if len(parts) < 2 or len(parts) > 5:
            raise ValueError(
                f"bad chaos rule {token!r}: want site:action[:p[:delay_s[:max_count]]]"
            )
        site, action = parts[0], parts[1]
        p = float(parts[2]) if len(parts) > 2 and parts[2] != "" else 1.0
        delay_s = float(parts[3]) if len(parts) > 3 and parts[3] != "" else 0.0
        max_count = int(parts[4]) if len(parts) > 4 and parts[4] != "" else None
        rules.append(
            ChaosRule(site=site, action=action, p=p, delay_s=delay_s, max_count=max_count)
        )
    return seed, rules


def _arm_from_env() -> None:
    import os

    spec = os.environ.get("PETALS_TPU_CHAOS")
    if not spec:
        return
    seed, rules = parse_spec(spec)  # malformed spec raises: fail loudly
    configure(seed=seed, rules=rules)


_arm_from_env()

__all__ = [
    "ACTIONS",
    "ENABLED",
    "MAX_LOG",
    "SITES",
    "SITE_ANNOUNCE",
    "SITE_DHT_LOOKUP",
    "SITE_HANDLER_STEP",
    "SITE_HANDOFF_PUSH",
    "SITE_INTEGRITY_CORRUPT",
    "SITE_MIGRATE_PUSH",
    "SITE_RPC_CALL",
    "SITE_RPC_STREAM",
    "SITE_RPC_STREAM_RECV",
    "SITE_SWAP_RESERVE",
    "ChaosInjected",
    "ChaosPlane",
    "ChaosRule",
    "configure",
    "corrupt_array",
    "disable",
    "fire",
    "get_plane",
    "inject",
    "parse_spec",
]
