"""Deterministic autoscaler policy: swarm snapshots in, decisions out.

The policy is a PURE function of its input sequence — no wall clocks
(time is the snapshot's integer ``tick``), no randomness, no I/O — so
the same snapshots always produce the same decisions, and the decision
journal (each decision + the evidence that justified it) is
byte-identical across replays, and equal to petals_tpu's policy
(petals_tpu/swarm/policy.py) on the same snapshots.

Three actions, strictly prioritized (at most ONE decision per tick, so
a chaos-perturbed snapshot can never trigger a decision storm):

- ``scale_out``: sustained hot signal (queue share over the admission
  lanes, or swarm TTFT p99 over the SLO bound) for ``sustain_out``
  consecutive ticks → spawn a replica over the weakest-coverage span.
- ``scale_in``: a replica cold (zero busy lanes, zero waiters) for
  ``sustain_in`` ticks, while the swarm is cool → drain-to-migrate it,
  but only if every block stays covered and ``min_replicas`` holds.
- ``resize``: a block has materially weaker throughput coverage than
  the strongest (the critical-path layer) → move the
  weakest-contribution movable replica's span onto it.

Hysteresis: the hot streak only RESETS once the swarm is fully cool
(below ``queue_share_low`` and the TTFT recovery bound), so a signal
flickering around the threshold neither fires early nor resets the
evidence. Cooldowns (in ticks) rate-limit per-action and globally, so
even adversarial snapshots can't cascade actions faster than the swarm
can absorb them. Capacity-removing actions (scale_in / resize) also
serve their cooldown once at controller START: with no streak history,
every replica looks cold on tick one, and draining on that evidence
would leave the swarm one kill away from losing coverage.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

__all__ = [
    "AutoscalerPolicy",
    "Decision",
    "PolicyConfig",
    "ServerSample",
    "SwarmSnapshot",
    "snapshot_from_health",
]


def _f(value, default: float = 0.0) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def _i(value, default: int = 0) -> int:
    try:
        return int(float(value))
    except (TypeError, ValueError, OverflowError):
        return default


@dataclasses.dataclass(frozen=True)
class ServerSample:
    """One server's contribution to a snapshot (from its DHT announce)."""

    peer: str  # peer id string (stable across ticks)
    start: int  # first block served (inclusive)
    end: int  # last block served (exclusive)
    state: str  # "online" | "joining" | "offline"
    throughput: float = 0.0  # announced tok/s capacity
    lanes: int = 0  # admission lanes (pool digest)
    busy_lanes: int = 0
    lane_waiters: int = 0  # sessions queued for a lane
    pages_free: int = 0
    n_pages: int = 0
    # integrity observatory: the replica announced itself quarantined (its
    # activation fingerprints diverged from its span-mates'). Quarantined
    # replicas are drained-and-replaced with top priority — they produce
    # WRONG tokens, which no amount of idle-harvesting hysteresis excuses.
    quarantined: bool = False
    # disaggregated serving phase tier ("generalist" | "prefill" | "decode");
    # tiered swarms get per-tier scaling signals, all-generalist swarms are
    # scored exactly as before this field existed
    tier: str = "generalist"

    @property
    def online(self) -> bool:
        return self.state == "online"


@dataclasses.dataclass(frozen=True)
class SwarmSnapshot:
    """Aggregate swarm state at one controller tick."""

    tick: int
    num_blocks: int
    servers: Tuple[ServerSample, ...] = ()
    ttft_p99_ms: Optional[float] = None  # swarm-wide worst announced p99

    def _tiered(self, tier: Optional[str]):
        return [
            s for s in self.servers
            if s.online and (tier is None or s.tier == tier)
        ]

    def queue_share(self, tier: Optional[str] = None) -> float:
        """Waiters per admission lane across ONLINE servers — the load
        signal that rises BEFORE latency does (queued sessions have not
        produced a slow token yet). ``tier`` restricts the aggregate to
        one phase tier (the prefill tier's scaling signal)."""
        servers = self._tiered(tier)
        lanes = sum(s.lanes for s in servers)
        waiters = sum(s.lane_waiters for s in servers)
        return waiters / lanes if lanes > 0 else 0.0

    def occupancy(self, tier: Optional[str] = None) -> float:
        servers = self._tiered(tier)
        lanes = sum(s.lanes for s in servers)
        busy = sum(s.busy_lanes for s in servers)
        return busy / lanes if lanes > 0 else 0.0

    def coverage(self) -> List[float]:
        """Per-block summed ONLINE throughput — the critical-path signal
        (the weakest block bounds swarm throughput; arxiv 2209.01188 §3)."""
        cov = [0.0] * self.num_blocks
        for s in self.servers:
            if not s.online:
                continue
            for b in range(max(0, s.start), min(self.num_blocks, s.end)):
                cov[b] += s.throughput
        return cov

    def replica_count(self, tier: Optional[str] = None) -> int:
        return len(self._tiered(tier))

    def tiers_present(self) -> Tuple[str, ...]:
        """Non-generalist tiers with at least one ONLINE replica, in the
        fixed (prefill, decode) order the per-tier actions evaluate in."""
        present = {s.tier for s in self.servers if s.online}
        return tuple(t for t in ("prefill", "decode") if t in present)


def snapshot_from_health(
    model_state: dict, *, tick: int, num_blocks: Optional[int] = None
) -> SwarmSnapshot:
    """Build a snapshot from one model's HealthMonitor state entry
    (``_state["models"][prefix]``). Tolerant per-field, like the health
    aggregates: a server missing pool/telemetry keys still contributes
    its span and state."""
    servers = []
    ttft: Optional[float] = None
    for peer, s in sorted((model_state.get("servers") or {}).items()):
        if not isinstance(s, dict):
            continue
        blocks = s.get("blocks") or [0, 0]
        pool = s.get("pool") if isinstance(s.get("pool"), dict) else {}
        integ = s.get("integrity") if isinstance(s.get("integrity"), dict) else {}
        servers.append(
            ServerSample(
                peer=str(peer),
                start=_i(blocks[0] if len(blocks) > 0 else 0),
                end=_i(blocks[1] if len(blocks) > 1 else 0),
                state=str(s.get("state") or "offline").lower(),
                throughput=_f(s.get("throughput")),
                lanes=_i(pool.get("lanes")),
                busy_lanes=_i(pool.get("busy_lanes")),
                lane_waiters=_i(pool.get("lane_waiters")),
                pages_free=_i(pool.get("pages_free")),
                n_pages=_i(pool.get("n_pages")),
                quarantined=bool(integ.get("quarantined")),
                tier=(
                    str(s.get("phase_tier")).lower()
                    if s.get("phase_tier") in ("prefill", "decode")
                    else "generalist"
                ),
            )
        )
        digest = s.get("telemetry")
        if isinstance(digest, dict):
            value = digest.get("ttft_p99_ms")
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                ttft = float(value) if ttft is None else max(ttft, float(value))
    return SwarmSnapshot(
        tick=tick,
        num_blocks=_i(num_blocks if num_blocks is not None else model_state.get("num_blocks")),
        servers=tuple(servers),
        ttft_p99_ms=ttft,
    )


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Thresholds and rate limits; every time-like field is in TICKS."""

    ttft_p99_ms: float = 10_000.0  # SLO bound: hot above this
    ttft_recovery: float = 0.8  # cool below bound * recovery (hysteresis)
    queue_share_high: float = 0.5  # hot: >= 1 waiter per 2 lanes
    queue_share_low: float = 0.1  # cool below this (hysteresis)
    sustain_out: int = 2  # consecutive hot ticks before scale-out
    sustain_in: int = 3  # consecutive cold ticks before scale-in
    cooldown_out: int = 5  # min ticks between scale-outs
    cooldown_in: int = 5  # min ticks between scale-ins
    cooldown_resize: int = 10  # min ticks between resizes
    cooldown_global: int = 2  # min ticks between ANY two decisions
    min_replicas: int = 1
    max_replicas: int = 8
    span_blocks: int = 0  # replica span length; 0 = full model
    resize_imbalance: float = 4.0  # resize when max/min coverage exceeds this

    # ---- disaggregated phase tiers (active only when the snapshot holds
    # tiered replicas; all-generalist swarms never evaluate these) ----
    # prefill tier scales on ITS OWN queue share (long prompts queue for
    # lanes long before swarm TTFT moves), decode tier on lane occupancy
    # (decode lanes saturate with near-zero queueing — each step is short,
    # so waiters drain fast while tok/s quietly degrades). Each tier has
    # an independent floor and scale-out cooldown.
    prefill_queue_share_high: float = 0.5
    prefill_queue_share_low: float = 0.1
    prefill_sustain_out: int = 2
    prefill_cooldown_out: int = 5
    prefill_min_replicas: int = 1
    decode_occupancy_high: float = 0.85
    decode_occupancy_low: float = 0.5
    decode_sustain_out: int = 2
    decode_cooldown_out: int = 5
    decode_min_replicas: int = 1

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not 0.0 <= self.queue_share_low <= self.queue_share_high:
            raise ValueError("need 0 <= queue_share_low <= queue_share_high")
        if not 0.0 <= self.prefill_queue_share_low <= self.prefill_queue_share_high:
            raise ValueError(
                "need 0 <= prefill_queue_share_low <= prefill_queue_share_high"
            )
        if not 0.0 <= self.decode_occupancy_low <= self.decode_occupancy_high:
            raise ValueError(
                "need 0 <= decode_occupancy_low <= decode_occupancy_high"
            )
        if self.prefill_min_replicas < 0 or self.decode_min_replicas < 0:
            raise ValueError("per-tier replica floors must be >= 0")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One autoscaling decision plus the evidence that justified it."""

    tick: int
    action: str  # "scale_out" | "scale_in" | "resize"
    target: Optional[str]  # peer id (scale_in / resize) or None (scale_out)
    span: Optional[Tuple[int, int]]  # blocks for the new/moved replica
    reason: str
    evidence: Dict[str, object]
    # phase tier the decision applies to ("prefill" | "decode"); None for
    # the tier-agnostic swarm-wide actions
    tier: Optional[str] = None

    def to_journal(self) -> dict:
        """Deterministic serializable form (floats rounded so replayed
        journals compare byte-identical; insertion order irrelevant —
        journal lines are dumped with sorted keys)."""

        def _round(v):
            if isinstance(v, bool):
                return v
            if isinstance(v, float):
                return round(v, 6)
            if isinstance(v, (list, tuple)):
                return [_round(x) for x in v]
            if isinstance(v, dict):
                return {k: _round(x) for k, x in v.items()}
            return v

        return {
            "tick": self.tick,
            "action": self.action,
            "target": self.target,
            "span": list(self.span) if self.span is not None else None,
            "reason": self.reason,
            "tier": self.tier,
            "evidence": _round(self.evidence),
        }


class AutoscalerPolicy:
    """Stateful but deterministic: streak counters and cooldown anchors
    advance only with ``observe()`` calls, keyed by snapshot ticks."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config or PolicyConfig()
        self._hot_streak = 0
        self._cold_streaks: Dict[str, int] = {}  # peer -> consecutive cold ticks
        # per-tier hot streaks (prefill: queue share, decode: occupancy);
        # empty until a snapshot actually contains tiered replicas
        self._tier_hot_streaks: Dict[str, int] = {}
        self._last_fire: Dict[str, int] = {}  # action -> tick it last fired
        self._last_any: Optional[int] = None
        self._first_tick: Optional[int] = None  # startup-grace anchor
        # span of a quarantined replica drained last decision: the NEXT
        # eligible tick issues the replacement scale_out over the same span
        self._pending_replace: Optional[Tuple[int, int]] = None
        self._journal: List[dict] = []

    # ------------------------------------------------------------- journal

    @property
    def journal(self) -> List[dict]:
        return list(self._journal)

    def journal_jsonl(self) -> str:
        """Canonical byte-stable rendering of the decision journal."""
        return "\n".join(
            json.dumps(entry, sort_keys=True, separators=(",", ":"))
            for entry in self._journal
        )

    # ------------------------------------------------------------- observe

    def observe(self, snapshot: SwarmSnapshot) -> List[Decision]:
        """Fold one snapshot into the streaks and return the decisions
        (0 or 1) it triggers. Priority: scale_out > scale_in > resize —
        relieving overload beats harvesting idle capacity."""
        cfg = self.config
        if self._first_tick is None:
            self._first_tick = snapshot.tick
        queue_share = snapshot.queue_share()
        ttft = snapshot.ttft_p99_ms

        hot = queue_share >= cfg.queue_share_high or (
            ttft is not None and ttft > cfg.ttft_p99_ms
        )
        cool = queue_share <= cfg.queue_share_low and (
            ttft is None or ttft <= cfg.ttft_p99_ms * cfg.ttft_recovery
        )
        if hot:
            self._hot_streak += 1
        elif cool:
            # hysteresis: the in-between band neither builds nor resets
            self._hot_streak = 0

        # per-tier hot streaks, same hysteresis discipline as the swarm-wide
        # streak: the in-between band neither builds nor resets. A tier that
        # disappears from the snapshot drops its streak (stale evidence must
        # not fire the first decision after the tier returns).
        present = snapshot.tiers_present()
        self._tier_hot_streaks = {
            t: n for t, n in self._tier_hot_streaks.items() if t in present
        }
        for t in present:
            t_hot, t_cool = self._tier_signal(snapshot, t)
            if t_hot:
                self._tier_hot_streaks[t] = self._tier_hot_streaks.get(t, 0) + 1
            elif t_cool:
                self._tier_hot_streaks[t] = 0

        # cold streaks per ONLINE replica; a replica that vanished from the
        # snapshot (killed, drained) drops its streak with it
        live = {s.peer for s in snapshot.servers if s.online}
        self._cold_streaks = {
            p: n for p, n in self._cold_streaks.items() if p in live
        }
        for s in snapshot.servers:
            if not s.online:
                continue
            if s.busy_lanes == 0 and s.lane_waiters == 0:
                self._cold_streaks[s.peer] = self._cold_streaks.get(s.peer, 0) + 1
            else:
                self._cold_streaks[s.peer] = 0

        evidence_base = {
            "queue_share": queue_share,
            "ttft_p99_ms": ttft,
            "occupancy": snapshot.occupancy(),
            "replicas": snapshot.replica_count(),
            "hot_streak": self._hot_streak,
        }

        decision = (
            # integrity first: a quarantined replica produces WRONG tokens —
            # draining it (and replacing its capacity) outranks every
            # latency-driven action
            self._maybe_quarantine_drain(snapshot, evidence_base)
            or self._maybe_scale_out(snapshot, evidence_base)
            or self._maybe_tier_scale_out(snapshot, evidence_base)
            or self._maybe_scale_in(snapshot, hot, evidence_base)
            or self._maybe_resize(snapshot, hot, evidence_base)
        )
        if decision is None:
            return []
        # tiered decisions cool down independently of the swarm-wide action
        # of the same name (independent per-tier cooldowns); both still share
        # the global cooldown via _last_any
        fire_key = (
            decision.action
            if decision.tier is None
            else f"{decision.action}:{decision.tier}"
        )
        self._last_fire[fire_key] = snapshot.tick
        self._last_any = snapshot.tick
        if decision.action == "scale_out":
            # the new capacity must re-earn the signal
            if decision.tier is None:
                self._hot_streak = 0
            else:
                self._tier_hot_streaks[decision.tier] = 0
        self._journal.append(decision.to_journal())
        return [decision]

    def _tier_signal(self, snapshot: SwarmSnapshot, tier: str) -> Tuple[bool, bool]:
        """(hot, cool) for one phase tier: prefill watches its queue share
        (heavy prompts queue for lanes before latency moves), decode its
        lane occupancy (decode steps are short, so lanes saturate with
        near-zero queueing while tok/s quietly degrades)."""
        cfg = self.config
        if tier == "prefill":
            share = snapshot.queue_share(tier="prefill")
            return (
                share >= cfg.prefill_queue_share_high,
                share <= cfg.prefill_queue_share_low,
            )
        occ = snapshot.occupancy(tier="decode")
        return occ >= cfg.decode_occupancy_high, occ <= cfg.decode_occupancy_low

    # ------------------------------------------------------------- actions

    def _maybe_quarantine_drain(
        self, snapshot: SwarmSnapshot, evidence: dict
    ) -> Optional[Decision]:
        """Drain-and-replace integrity-quarantined replicas.

        Bypasses the cold-streak/hysteresis machinery (the evidence is the
        canary prober's quorum, not an occupancy signal) and the startup
        grace, but still honors the global cooldown so a multi-replica
        quarantine unwinds one decision per ``cooldown_global`` ticks.
        Coverage-preserving both ways: when draining would uncover blocks,
        the REPLACEMENT is spawned first and the drain happens on a later
        tick, once the new replica covers the span."""
        cfg = self.config
        if (
            self._last_any is not None
            and snapshot.tick - self._last_any < cfg.cooldown_global
        ):
            return None
        quarantined = sorted(
            (s for s in snapshot.servers if s.online and s.quarantined),
            key=lambda s: s.peer,
        )
        # replacement owed from a previous drain fires before anything else
        if self._pending_replace is not None:
            span = self._pending_replace
            if snapshot.replica_count() >= cfg.max_replicas:
                self._pending_replace = None  # the swarm is full; drop the IOU
            else:
                self._pending_replace = None
                return Decision(
                    tick=snapshot.tick,
                    action="scale_out",
                    target=None,
                    span=span,
                    reason="replace drained quarantined replica",
                    evidence={**evidence, "quarantined": [s.peer for s in quarantined]},
                )
        if not quarantined:
            return None
        victim = quarantined[0]
        ev = {
            **evidence,
            "quarantined": [s.peer for s in quarantined],
            "victim": victim.peer,
        }
        if (
            snapshot.replica_count() > cfg.min_replicas
            and self._still_covered(snapshot, without=victim.peer)
        ):
            self._pending_replace = (victim.start, victim.end)
            return Decision(
                tick=snapshot.tick,
                action="scale_in",
                target=victim.peer,
                span=(victim.start, victim.end),
                reason="integrity quarantine: drain divergent replica",
                evidence=ev,
            )
        # sole coverage of its blocks: spawn the replacement FIRST; the
        # drain fires on a later tick once the new replica is online
        if snapshot.replica_count() < cfg.max_replicas:
            return Decision(
                tick=snapshot.tick,
                action="scale_out",
                target=None,
                span=(victim.start, victim.end),
                reason="integrity quarantine: replace sole-coverage replica",
                evidence=ev,
            )
        return None

    def _cooled_down(self, action: str, cooldown: int, tick: int) -> bool:
        last = self._last_fire.get(action)
        if last is None and not action.startswith("scale_out"):
            # Startup grace: at controller start EVERY replica looks cold
            # (no streak history says otherwise), so capacity-REMOVING
            # actions must watch the swarm for a full cooldown before
            # their first fire. Scale-out stays immediate — adding
            # capacity early is cheap, harvesting early can strand the
            # swarm one kill away from losing coverage.
            last = self._first_tick
        if last is not None and tick - last < cooldown:
            return False
        if self._last_any is not None and tick - self._last_any < self.config.cooldown_global:
            return False
        return True

    def _span_for_scale_out(self, snapshot: SwarmSnapshot) -> Tuple[int, int]:
        """Weakest contiguous coverage window of the configured span length
        (lowest summed throughput; deterministic tie-break: lowest start)."""
        cfg = self.config
        length = cfg.span_blocks or snapshot.num_blocks
        length = max(1, min(length, snapshot.num_blocks))
        cov = snapshot.coverage()
        best_start, best_sum = 0, None
        window = sum(cov[0:length])
        for start in range(0, snapshot.num_blocks - length + 1):
            if start > 0:
                window += cov[start + length - 1] - cov[start - 1]
            if best_sum is None or window < best_sum:
                best_start, best_sum = start, window
        return best_start, best_start + length

    def _maybe_scale_out(self, snapshot: SwarmSnapshot, evidence: dict) -> Optional[Decision]:
        cfg = self.config
        if self._hot_streak < cfg.sustain_out:
            return None
        if snapshot.replica_count() >= cfg.max_replicas:
            return None
        if not self._cooled_down("scale_out", cfg.cooldown_out, snapshot.tick):
            return None
        span = self._span_for_scale_out(snapshot)
        cov = snapshot.coverage()
        return Decision(
            tick=snapshot.tick,
            action="scale_out",
            target=None,
            span=span,
            reason=(
                "sustained hot signal "
                f"({self._hot_streak} ticks >= sustain_out={cfg.sustain_out})"
            ),
            evidence={
                **evidence,
                "window_coverage": sum(cov[span[0]:span[1]]),
            },
        )

    def _maybe_tier_scale_out(
        self, snapshot: SwarmSnapshot, evidence: dict
    ) -> Optional[Decision]:
        """Per-tier scale-out for disaggregated swarms: prefill on its own
        queue share, decode on its lane occupancy (see ``_tier_signal``),
        each with an independent sustain and cooldown. Evaluates only tiers
        actually present in the snapshot — an all-generalist swarm never
        reaches this code path, so legacy decision streams are unchanged."""
        cfg = self.config
        if snapshot.replica_count() >= cfg.max_replicas:
            return None
        for tier in snapshot.tiers_present():
            sustain, cooldown = (
                (cfg.prefill_sustain_out, cfg.prefill_cooldown_out)
                if tier == "prefill"
                else (cfg.decode_sustain_out, cfg.decode_cooldown_out)
            )
            if self._tier_hot_streaks.get(tier, 0) < sustain:
                continue
            if not self._cooled_down(f"scale_out:{tier}", cooldown, snapshot.tick):
                continue
            span = self._span_for_scale_out(snapshot)
            signal = (
                {"tier_queue_share": snapshot.queue_share(tier="prefill")}
                if tier == "prefill"
                else {"tier_occupancy": snapshot.occupancy(tier="decode")}
            )
            return Decision(
                tick=snapshot.tick,
                action="scale_out",
                target=None,
                span=span,
                tier=tier,
                reason=(
                    f"{tier} tier hot for {self._tier_hot_streaks[tier]} ticks "
                    f">= sustain={sustain}"
                ),
                evidence={
                    **evidence,
                    **signal,
                    "tier_replicas": snapshot.replica_count(tier=tier),
                    "tier_hot_streak": self._tier_hot_streaks[tier],
                },
            )
        return None

    def _tier_floor_holds(self, snapshot: SwarmSnapshot, victim: ServerSample) -> bool:
        """Independent per-tier floors: harvesting a tiered replica must not
        drop its tier below the configured minimum (a decode tier emptied by
        idle-harvesting would silently re-colocate every handoff)."""
        cfg = self.config
        if victim.tier == "prefill":
            return snapshot.replica_count(tier="prefill") > cfg.prefill_min_replicas
        if victim.tier == "decode":
            return snapshot.replica_count(tier="decode") > cfg.decode_min_replicas
        return True

    def _still_covered(self, snapshot: SwarmSnapshot, without: str) -> bool:
        cov = [0] * snapshot.num_blocks
        for s in snapshot.servers:
            if not s.online or s.peer == without:
                continue
            for b in range(max(0, s.start), min(snapshot.num_blocks, s.end)):
                cov[b] += 1
        return all(c > 0 for c in cov) if cov else False

    def _maybe_scale_in(
        self, snapshot: SwarmSnapshot, hot: bool, evidence: dict
    ) -> Optional[Decision]:
        cfg = self.config
        if hot:  # never harvest capacity while the swarm is hot
            return None
        if snapshot.replica_count() <= cfg.min_replicas:
            return None
        if not self._cooled_down("scale_in", cfg.cooldown_in, snapshot.tick):
            return None
        candidates = [
            s
            for s in snapshot.servers
            if s.online
            and self._cold_streaks.get(s.peer, 0) >= cfg.sustain_in
            and self._still_covered(snapshot, without=s.peer)
            and self._tier_floor_holds(snapshot, s)
        ]
        if not candidates:
            return None
        # coldest = lowest throughput; tie-break on peer id for determinism
        victim = min(candidates, key=lambda s: (s.throughput, s.peer))
        return Decision(
            tick=snapshot.tick,
            action="scale_in",
            target=victim.peer,
            span=(victim.start, victim.end),
            tier=victim.tier if victim.tier != "generalist" else None,
            reason=(
                f"replica cold for {self._cold_streaks[victim.peer]} ticks "
                f">= sustain_in={cfg.sustain_in}"
            ),
            evidence={
                **evidence,
                "cold_streak": self._cold_streaks[victim.peer],
                "victim_throughput": victim.throughput,
            },
        )

    def _maybe_resize(
        self, snapshot: SwarmSnapshot, hot: bool, evidence: dict
    ) -> Optional[Decision]:
        """Span-boundary resize: when one block's coverage is a factor of
        ``resize_imbalance`` weaker than the strongest, move the weakest
        movable partial-span replica onto the critical-path block."""
        cfg = self.config
        if hot:  # scale-out pressure owns hot swarms
            return None
        if not self._cooled_down("resize", cfg.cooldown_resize, snapshot.tick):
            return None
        cov = snapshot.coverage()
        if not cov:
            return None
        weakest = min(range(len(cov)), key=lambda b: (cov[b], b))
        strongest = max(cov)
        if cov[weakest] > 0 and strongest / max(cov[weakest], 1e-9) < cfg.resize_imbalance:
            return None
        movable = [
            s
            for s in snapshot.servers
            if s.online
            and (s.end - s.start) < snapshot.num_blocks  # full-span: nothing to move
            and not (s.start <= weakest < s.end)  # already covers it
            and self._cold_streaks.get(s.peer, 0) >= 1  # don't yank a busy replica
            and self._still_covered(snapshot, without=s.peer)
        ]
        if not movable:
            return None
        mover = min(movable, key=lambda s: (s.throughput, s.peer))
        length = mover.end - mover.start
        new_start = max(0, min(weakest - length // 2, snapshot.num_blocks - length))
        if (new_start, new_start + length) == (mover.start, mover.end):
            return None
        return Decision(
            tick=snapshot.tick,
            action="resize",
            target=mover.peer,
            span=(new_start, new_start + length),
            reason=(
                f"block {weakest} coverage {cov[weakest]:.3f} vs strongest "
                f"{strongest:.3f} (imbalance >= {cfg.resize_imbalance})"
            ),
            evidence={
                **evidence,
                "weakest_block": weakest,
                "weakest_coverage": cov[weakest],
                "strongest_coverage": strongest,
                "old_span": [mover.start, mover.end],
            },
        )
