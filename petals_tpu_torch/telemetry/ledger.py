"""Per-tenant resource ledger: who is this server spending itself on?
(the port's copy of petals_tpu/telemetry/ledger.py)

A ``ResourceLedger`` meters whom a server spends itself on, per session and
rolled up per peer:

- **page-seconds** — HBM page residency integrated over wall time. COW-shared
  prefix pages are attributed fractionally by refcount: a page with refcount
  R referenced by a lane contributes 1/R to that lane, so the per-session
  split always sums to the pool occupancy integral (the remainder — prefix
  -cache pins with no live lane — accrues as ``unattributed``).
- **lane-seconds** — lane residency (the dense pool has no pages; a held
  lane is the unit of occupancy there).
- **compute-seconds** — each batched tick's wall time split across the lanes
  that participated in it (a 4-lane decode tick of 8ms bills 2ms per lane).
- **prefill/decode tokens**, **swap bytes** in/out, **migrated bytes**.

Accrual is piecewise-constant: the batcher pushes a new rate snapshot at
every occupancy-changing boundary (admission, release, page alloc/fork,
prefix adopt/pin/unpin, swap in/out — the sites where ``_note_occupancy``
already runs) and the ledger integrates the PREVIOUS rates over the elapsed
interval. Reads (snapshot / usage_delta / conservation) integrate lazily up
to "now" without touching the rates, so the decode hot path never settles.

Peer cardinality is bounded the same way the metrics registry bounds label
sets: past ``max_peers`` distinct peers, new peers collapse into the shared
``"_overflow"`` rollup (``peer_overflows`` and
``petals_ledger_peer_overflow_total`` count the collapse). Peer ids never
become metric labels; they live only in this ledger's bounded dicts
and its JSON views.

On top of the meters sits a DRF-style noisy-neighbor detector: a rolling
window of per-peer cumulative totals yields each peer's dominant-resource
share (max over resources of its share of that resource's window delta).
A peer exceeding a configurable share while OTHER peers' admissions queue is
a noisy neighbor: ``check_noisy`` returns an evidence dict (the batcher
journals it with the occupancy attached), bumps ``noisy_events`` and
``petals_ledger_noisy_neighbors_total``, and files the evidence with the
ledger's snapshot to the flight recorder (one attached with
``attach_flight``, else one made on first use, as petals_tpu's).

Layering: like the rest of the telemetry package, this module imports
nothing from the rest of the port. The batcher/scheduler pull the ledger
in, never the other way around.

The ``petals_ledger_*`` metrics (telemetry/instruments.py) are recorded
where petals_tpu's ledger records them, and ``/ledger``
(telemetry/exposition.py) serves ``snapshot``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

# the metrics registry's bound on one metric's label sets, which the
# ledger's peer cardinality follows
from petals_tpu_torch.telemetry.registry import DEFAULT_MAX_SERIES  # noqa: E402

ANON_PEER = "_anon"  # unidentified clients (no proven peer id, no hint)
OVERFLOW_PEER = "_overflow"  # shared rollup once max_peers distinct peers seen

# Resource dimensions the DRF detector considers for dominant share. These
# are the contended server resources; migrated bytes are excluded (migration
# is the server's own rebalancing, not client demand).
DRF_RESOURCES = ("page_seconds", "compute_seconds", "tokens", "swap_bytes")

# Per-resource activity floors: a resource with a window delta below its
# floor is not contended and cannot define anyone's dominant share (without
# this, the first session to touch an idle resource "dominates" it at 100%).
_DRF_FLOORS = {
    "page_seconds": 1e-6,
    "compute_seconds": 1e-6,
    "tokens": 1.0,
    "swap_bytes": 1.0,
}

USAGE_FIELDS = (
    "page_seconds",
    "lane_seconds",
    "compute_seconds",
    # speculative decoding: draft_seconds is an "of which" annotation INSIDE
    # compute_seconds (the batcher bills the whole tick wall via note_compute,
    # so the conservation story is unchanged; draft_seconds records how much
    # of a session's compute went to the draft model). spec_proposed /
    # spec_accepted count draft tokens offered to and accepted by the verify
    # step — their ratio is the peer's acceptance_rate.
    "draft_seconds",
    "spec_proposed",
    "spec_accepted",
    "prefill_tokens",
    "decode_tokens",
    "swap_out_bytes",
    "swap_in_bytes",
    "migrated_bytes",
)


_TM = None


def _tm():
    """The instruments module, imported at first use (it registers on the
    package's metrics registry)."""
    global _TM
    if _TM is None:
        from petals_tpu_torch.telemetry import instruments

        _TM = instruments
    return _TM


def derive_efficiency(usage: Dict[str, float]) -> Dict[str, float]:
    """Speculation-efficiency ratios derived from a usage dict: per-peer
    ``acceptance_rate`` (accepted/proposed draft tokens; 0.0 before any
    proposal) and ``tokens_per_compute_second`` (all tokens produced per
    compute-second billed — the "is speculation paying for itself" number
    clients read off /ledger and step_meta)."""
    proposed = usage.get("spec_proposed", 0.0)
    compute_s = usage.get("compute_seconds", 0.0)
    tokens = usage.get("prefill_tokens", 0.0) + usage.get("decode_tokens", 0.0)
    return {
        "acceptance_rate": (
            round(usage.get("spec_accepted", 0.0) / proposed, 4) if proposed > 0 else 0.0
        ),
        "tokens_per_compute_second": (
            round(tokens / compute_s, 4) if compute_s > 0 else 0.0
        ),
    }


def _zero_usage() -> Dict[str, float]:
    return {f: 0.0 for f in USAGE_FIELDS}


def _fold(dst: Dict[str, float], src: Dict[str, float]) -> None:
    for f in USAGE_FIELDS:
        dst[f] += src[f]


def normalize_peer(peer_id: Optional[str]) -> str:
    """Collapse missing/empty peer ids to the anonymous bucket and clip
    oversized ids (peer ids are request-adjacent strings; the ledger must
    not become a memory amplifier for a hostile opener)."""
    if not peer_id:
        return ANON_PEER
    peer_id = str(peer_id)
    return peer_id[:64] if len(peer_id) > 64 else peer_id


class _Session:
    """One admitted session's live accumulators + current accrual rates."""

    __slots__ = (
        "key", "peer", "trace_id", "opened_t",
        "page_rate", "lane_rate", "totals", "delta_mark",
    )

    def __init__(self, key: str, peer: str, trace_id: Optional[str], now: float):
        self.key = key
        self.peer = peer
        self.trace_id = trace_id
        self.opened_t = now
        self.page_rate = 0.0  # fractional pages held (sum of 1/refcount)
        self.lane_rate = 0.0  # lanes held (1.0 while admitted)
        self.totals = _zero_usage()
        self.delta_mark = _zero_usage()  # totals at the last usage_delta pop


class ResourceLedger:
    """Thread-safe per-session / per-peer resource meter with a rolling-
    window dominant-resource-fairness view. One instance per batcher; the
    process singleton (``get_ledger``) backs exposition and the announce
    digest. All methods are safe from both the event loop and the compute
    thread — state lives behind one plain leaf lock (never held across
    user code, matching the registry's locking discipline)."""

    def __init__(
        self,
        *,
        max_peers: int = DEFAULT_MAX_SERIES,
        window_s: float = 30.0,
        noisy_share: float = 0.5,
        noisy_min_interval_s: float = 0.25,
        noisy_cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_peers = int(max_peers)
        self.window_s = float(window_s)
        self.noisy_share = float(noisy_share)
        self.noisy_min_interval_s = float(noisy_min_interval_s)
        self.noisy_cooldown_s = float(noisy_cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: Dict[str, _Session] = {}
        self._closed_peers: Dict[str, Dict[str, float]] = {}  # folded rollups
        self._known_peers: set = set()
        self._seq = 0
        self._last_settle = clock()
        self._pool_rate = 0.0  # occupied pages (the independent integral)
        self.pool_page_seconds = 0.0
        self.unattributed_page_seconds = 0.0  # prefix pins with no live lane
        self.peer_overflows = 0
        self.noisy_events = 0
        # rolling DRF window: (t, {peer: {resource: cumulative}}) samples,
        # seeded with an empty baseline so the first share read is already
        # a delta against zero rather than against itself
        self._window: deque = deque([(self._last_settle, {})])
        self._last_sample = -float("inf")
        self._last_check = -float("inf")
        self._last_noisy: Dict[str, float] = {}
        # KV storage economics (set by the batcher at pool creation): wire
        # bytes one cached token costs across this server's span, and the
        # pool's quantization kind — lets /ledger readers convert the
        # page-second integrals into actual HBM bytes
        self.kv_quant: str = "none"
        self.kv_bytes_per_token: Optional[int] = None
        # prefix-cache residency: per-tenant resident bytes (all tiers)
        # pushed by the radix cache at every mutation boundary and integrated
        # piecewise-constant like the page rates. A SEPARATE channel from
        # page-seconds on purpose: cache residency must bill tenants without
        # perturbing the pool conservation invariant (attributed +
        # unattributed == pool_page_seconds) or the DRF resource vector.
        self._cache_rates: Dict[str, float] = {}
        self._cache_rollup: Dict[str, float] = {}
        self.cache_byte_seconds = 0.0

    def set_kv_cost(self, kv_quant: str, bytes_per_token: int) -> None:
        """Record the paged pool's storage kind and per-token wire cost so
        the /ledger efficiency blobs can price page-seconds in bytes."""
        self.kv_quant = str(kv_quant or "none")
        self.kv_bytes_per_token = int(bytes_per_token)

    # ------------------------------------------------------------- lifecycle

    def open_session(
        self, peer_id: Optional[str], trace_id: Optional[str] = None
    ) -> str:
        """Admit a session under ``peer_id`` (None -> anonymous bucket).
        Returns the opaque session key the batcher stores per lane."""
        peer = normalize_peer(peer_id)
        with self._lock:
            now = self._clock()
            self._settle_locked(now)
            if peer not in self._known_peers:
                if len(self._known_peers) >= self.max_peers:
                    peer = OVERFLOW_PEER
                    self.peer_overflows += 1
                    _tm().LEDGER_PEER_OVERFLOW.inc()
                else:
                    self._known_peers.add(peer)
            self._seq += 1
            key = f"s{self._seq}"
            self._sessions[key] = _Session(key, peer, trace_id, now)
            n_sessions, n_peers = len(self._sessions), len(self._known_peers)
        tm = _tm()
        tm.LEDGER_SESSIONS.set(n_sessions)
        tm.LEDGER_PEERS.set(n_peers)
        return key

    def close_session(self, key: str) -> Dict[str, float]:
        """Final settle; fold the session's totals into its peer rollup and
        return them."""
        with self._lock:
            self._settle_locked(self._clock())
            sess = self._sessions.pop(key, None)
            if sess is None:
                return _zero_usage()
            rollup = self._closed_peers.setdefault(sess.peer, _zero_usage())
            _fold(rollup, sess.totals)
            totals = dict(sess.totals)
            n_sessions = len(self._sessions)
        _tm().LEDGER_SESSIONS.set(n_sessions)
        return totals

    # --------------------------------------------------------------- accrual

    def set_rates(
        self,
        page_weights: Dict[str, float],
        pool_occupied: float,
        lane_keys: Optional[Sequence[str]] = None,
    ) -> None:
        """Settle the elapsed interval under the OLD rates, then install the
        new piecewise-constant snapshot: ``page_weights`` maps session key ->
        fractional pages held (sum of 1/refcount over its block-table row),
        ``pool_occupied`` is total allocated pages, and ``lane_keys`` lists
        sessions currently holding a lane (defaults to all live sessions)."""
        with self._lock:
            self._settle_locked(self._clock())
            lane_set = set(lane_keys) if lane_keys is not None else None
            for key, sess in self._sessions.items():
                sess.page_rate = float(page_weights.get(key, 0.0))
                sess.lane_rate = (
                    1.0 if (lane_set is None or key in lane_set) else 0.0
                )
            self._pool_rate = max(float(pool_occupied), 0.0)

    def set_cache_rates(self, peer_bytes: Dict[Optional[str], float]) -> None:
        """Settle the elapsed interval, then install the prefix cache's new
        per-tenant resident-byte rates (host + device + swap + pinned-page
        bytes, summed per owning tenant). Tenants respect the same
        cardinality bound as sessions: past ``max_peers``, new ones collapse
        into the overflow rollup."""
        with self._lock:
            self._settle_locked(self._clock())
            rates: Dict[str, float] = {}
            for peer_id, nbytes in peer_bytes.items():
                peer = normalize_peer(peer_id)
                if peer not in self._known_peers:
                    if len(self._known_peers) >= self.max_peers:
                        peer = OVERFLOW_PEER
                    else:
                        self._known_peers.add(peer)
                rates[peer] = rates.get(peer, 0.0) + max(float(nbytes), 0.0)
            self._cache_rates = rates

    def note_compute(self, keys: Sequence[str], seconds: float) -> None:
        """Split one batched tick's wall time equally across the lanes that
        participated in it. Called from the compute thread."""
        if not keys or seconds <= 0:
            return
        share = float(seconds) / len(keys)
        with self._lock:
            for key in keys:
                sess = self._sessions.get(key)
                if sess is not None:
                    sess.totals["compute_seconds"] += share
        _tm().LEDGER_COMPUTE_SECONDS.inc(float(seconds))

    def note_spec(
        self, key: str, *, draft_seconds: float = 0.0,
        proposed: int = 0, accepted: int = 0,
    ) -> None:
        """Record one speculating lane's share of a spec tick: its slice of
        the draft model's wall time (an "of which" annotation inside the
        compute-seconds already billed by note_compute) plus its proposed /
        accepted draft-token counts. Called from the compute thread."""
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:
                sess.totals["draft_seconds"] += draft_seconds
                sess.totals["spec_proposed"] += proposed
                sess.totals["spec_accepted"] += accepted

    def note_tokens(self, key: str, *, prefill: int = 0, decode: int = 0) -> None:
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:
                sess.totals["prefill_tokens"] += prefill
                sess.totals["decode_tokens"] += decode

    def note_swap(self, key: str, *, out_bytes: int = 0, in_bytes: int = 0) -> None:
        with self._lock:
            sess = self._sessions.get(key)
            if sess is not None:
                sess.totals["swap_out_bytes"] += out_bytes
                sess.totals["swap_in_bytes"] += in_bytes

    def note_migrated(
        self, key: Optional[str], nbytes: int, *, peer_id: Optional[str] = None
    ) -> None:
        """Attribute server-to-server migrated KV bytes: to the live session
        when one exists (adopt path), else directly to the peer rollup (the
        out-push happens after the session was parked and closed)."""
        with self._lock:
            sess = self._sessions.get(key) if key is not None else None
            if sess is not None:
                sess.totals["migrated_bytes"] += nbytes
                return
            peer = normalize_peer(peer_id)
            if peer not in self._known_peers:
                if len(self._known_peers) >= self.max_peers:
                    peer = OVERFLOW_PEER
                else:
                    self._known_peers.add(peer)
            rollup = self._closed_peers.setdefault(peer, _zero_usage())
            rollup["migrated_bytes"] += nbytes

    # ----------------------------------------------------------- integration

    def _settle_locked(self, now: float) -> None:
        """Integrate the stored rates over [last_settle, now]."""
        dt = now - self._last_settle
        if dt <= 0:
            return
        self._last_settle = now
        attributed = 0.0
        for sess in self._sessions.values():
            if sess.page_rate:
                inc = sess.page_rate * dt
                sess.totals["page_seconds"] += inc
                attributed += inc
            if sess.lane_rate:
                sess.totals["lane_seconds"] += sess.lane_rate * dt
        pool_inc = self._pool_rate * dt
        self.pool_page_seconds += pool_inc
        # remainder = pages whose refs are held only by the prefix cache
        # (no live lane). Clamp per-interval: a racy weights snapshot can
        # transiently exceed the pool occupancy it was taken against.
        unattributed_inc = max(pool_inc - attributed, 0.0)
        self.unattributed_page_seconds += unattributed_inc
        cache_inc = 0.0
        if self._cache_rates:
            for peer, rate in self._cache_rates.items():
                if rate:
                    inc = rate * dt
                    self._cache_rollup[peer] = self._cache_rollup.get(peer, 0.0) + inc
                    cache_inc += inc
            self.cache_byte_seconds += cache_inc
        if attributed or unattributed_inc or cache_inc:
            tm = _tm()
            if attributed:
                tm.LEDGER_PAGE_SECONDS.inc(attributed)
            if unattributed_inc:
                tm.LEDGER_UNATTRIBUTED_PAGE_SECONDS.inc(unattributed_inc)
            if cache_inc:
                tm.LEDGER_CACHE_BYTE_SECONDS.inc(cache_inc)

    # ----------------------------------------------------------------- reads

    def usage_delta(self, key: str) -> Optional[Dict[str, float]]:
        """Per-session usage since the previous call — the per-step bill
        piggybacked on step_meta. Returns only non-zero fields (compact on
        the wire); None for an unknown session."""
        with self._lock:
            self._settle_locked(self._clock())
            sess = self._sessions.get(key)
            if sess is None:
                return None
            out = {}
            for f in USAGE_FIELDS:
                d = sess.totals[f] - sess.delta_mark[f]
                if d > 0:
                    out[f] = int(d) if float(d).is_integer() else round(d, 6)
                sess.delta_mark[f] = sess.totals[f]
            return out

    def session_usage(self, key: str) -> Optional[Dict[str, float]]:
        with self._lock:
            self._settle_locked(self._clock())
            sess = self._sessions.get(key)
            return dict(sess.totals) if sess is not None else None

    def peer_totals(self) -> Dict[str, Dict[str, float]]:
        """Closed-session rollups + live sessions, folded per peer."""
        with self._lock:
            self._settle_locked(self._clock())
            return self._peer_totals_locked()

    def _peer_totals_locked(self) -> Dict[str, Dict[str, float]]:
        out = {p: dict(u) for p, u in self._closed_peers.items()}
        for sess in self._sessions.values():
            _fold(out.setdefault(sess.peer, _zero_usage()), sess.totals)
        return out

    def cache_residency(self) -> Dict[str, float]:
        """Per-tenant prefix-cache byte-seconds accrued so far (lazy settle
        up to now, like every other read)."""
        with self._lock:
            self._settle_locked(self._clock())
            return dict(self._cache_rollup)

    def attributed_page_seconds(self) -> float:
        """Sum of every session's page-seconds (live + folded). Conservation:
        this plus ``unattributed_page_seconds`` equals ``pool_page_seconds``
        within float tolerance — the bench gate rows assert it."""
        totals = self.peer_totals()
        return sum(u["page_seconds"] for u in totals.values())

    # ------------------------------------------------------------------- DRF

    def _drf_vector(self, usage: Dict[str, float]) -> Dict[str, float]:
        return {
            "page_seconds": usage["page_seconds"],
            "compute_seconds": usage["compute_seconds"],
            "tokens": usage["prefill_tokens"] + usage["decode_tokens"],
            "swap_bytes": usage["swap_out_bytes"] + usage["swap_in_bytes"],
        }

    def _sample_locked(self, now: float) -> None:
        """Append a cumulative-totals sample to the rolling window and prune
        samples that have aged out (always keeping one baseline at or beyond
        the window edge so deltas span the full window)."""
        self._last_sample = now
        totals = self._peer_totals_locked()
        self._window.append((now, {p: self._drf_vector(u) for p, u in totals.items()}))
        while len(self._window) >= 2 and self._window[1][0] <= now - self.window_s:
            self._window.popleft()

    def _shares_locked(self, now: float) -> Dict[str, tuple]:
        """Per-peer (dominant_share, dominant_resource) over the window."""
        if not self._window:
            return {}
        base_t, base = self._window[0]
        cur = {p: self._drf_vector(u) for p, u in self._peer_totals_locked().items()}
        deltas: Dict[str, Dict[str, float]] = {}
        totals = {r: 0.0 for r in DRF_RESOURCES}
        for peer, vec in cur.items():
            b = base.get(peer, {})
            d = {r: max(vec[r] - b.get(r, 0.0), 0.0) for r in DRF_RESOURCES}
            deltas[peer] = d
            for r in DRF_RESOURCES:
                totals[r] += d[r]
        shares: Dict[str, tuple] = {}
        for peer, d in deltas.items():
            best, best_r = 0.0, None
            for r in DRF_RESOURCES:
                if totals[r] <= _DRF_FLOORS[r]:
                    continue  # uncontended resource: cannot define dominance
                s = d[r] / totals[r]
                if s > best:
                    best, best_r = s, r
            shares[peer] = (best, best_r)
        return shares

    def rebase_window(self) -> None:
        """Restart the DRF window from the current totals: shares and noisy
        detection then reflect only activity from this instant on. For
        operators resuming after a maintenance pause (stale baselines would
        bill the whole gap to whoever was active before it) and for tests
        that reuse the process singleton."""
        with self._lock:
            now = self._clock()
            self._settle_locked(now)
            base = {
                p: self._drf_vector(u)
                for p, u in self._peer_totals_locked().items()
            }
            self._window.clear()
            self._window.append((now, base))
            self._last_sample = now

    def peer_dominant_share(self, peer_id: Optional[str]) -> float:
        """Rolling-window dominant-resource share of ``peer_id`` in [0, 1] —
        the scheduler's fair-share rank (0.0 for unknown/idle peers)."""
        peer = normalize_peer(peer_id)
        with self._lock:
            now = self._clock()
            self._settle_locked(now)
            if now - self._last_sample >= max(self.noisy_min_interval_s, 1e-9):
                self._sample_locked(now)
            shares = self._shares_locked(now)
            share = shares.get(peer)
            if share is None and peer not in self._known_peers:
                share = shares.get(OVERFLOW_PEER)  # collapsed peers rank together
            return share[0] if share else 0.0

    def check_noisy(self, queued_peers: Sequence[Optional[str]]) -> Optional[dict]:
        """Fire the noisy-neighbor detector: a peer whose dominant-resource
        share exceeds ``noisy_share`` while at least one OTHER peer's
        admission queues. Returns an evidence dict (caller journals it with
        occupancy attached) or None; throttled by ``noisy_min_interval_s``
        with a per-peer ``noisy_cooldown_s``. Also bumps the counter and
        files a flight-recorder entry with the ledger snapshot."""
        queued = [normalize_peer(p) for p in queued_peers]
        if not queued:
            return None
        with self._lock:
            now = self._clock()
            self._settle_locked(now)
            if now - self._last_check < self.noisy_min_interval_s:
                return None
            self._last_check = now
            self._sample_locked(now)
            shares = self._shares_locked(now)
            evidence = None
            for peer, (share, resource) in sorted(
                shares.items(), key=lambda kv: -kv[1][0]
            ):
                if share < self.noisy_share or resource is None:
                    continue
                if not any(q != peer for q in queued):
                    continue  # only its own admissions queue: not a neighbor problem
                if now - self._last_noisy.get(peer, -float("inf")) < self.noisy_cooldown_s:
                    continue
                self._last_noisy[peer] = now
                self.noisy_events += 1
                evidence = {
                    "peer": peer,
                    "dominant_share": round(share, 4),
                    "dominant_resource": resource,
                    "window_s": self.window_s,
                    "queued_peers": sorted(set(queued)),
                    "top": self._top_locked(5),
                }
                break
            if evidence is None:
                return None
            snapshot = self._snapshot_locked(k=8)
        _tm().LEDGER_NOISY_NEIGHBORS.inc()
        self._flight_record(evidence, snapshot)
        return evidence

    # ------------------------------------------------------------------ views

    def _top_locked(self, k: int) -> List[dict]:
        shares = self._shares_locked(self._clock())
        totals = self._peer_totals_locked()
        for peer in self._cache_rollup:
            # a tenant can hold cache residency with no live/closed session
            # (its sessions drained but its tree nodes survive them) — it
            # must still show up in the bill
            totals.setdefault(peer, _zero_usage())
        rows = []
        for peer, usage in totals.items():
            share, resource = shares.get(peer, (0.0, None))
            rows.append({
                "peer": peer,
                "share": round(share, 4),
                "resource": resource,
                "page_s": round(usage["page_seconds"], 4),
                "compute_s": round(usage["compute_seconds"], 4),
                "draft_s": round(usage["draft_seconds"], 4),
                "tokens": int(usage["prefill_tokens"] + usage["decode_tokens"]),
                "swap_bytes": int(usage["swap_out_bytes"] + usage["swap_in_bytes"]),
                "migrated_bytes": int(usage["migrated_bytes"]),
                "cache_byte_s": round(self._cache_rollup.get(peer, 0.0), 1),
                **derive_efficiency(usage),
            })
        rows.sort(key=lambda r: (-r["share"], -r["page_s"], -r["compute_s"], r["peer"]))
        return rows[:k]

    def top_peers(self, k: int = 10) -> List[dict]:
        """Top-k consumers by dominant-resource share (ties by page-seconds)."""
        with self._lock:
            self._settle_locked(self._clock())
            return self._top_locked(k)

    def snapshot(self, k: int = 10) -> dict:
        """The /ledger view: pool integrals, per-peer top-k, live sessions."""
        with self._lock:
            self._settle_locked(self._clock())
            return self._snapshot_locked(k)

    def _snapshot_locked(self, k: int) -> dict:
        now = self._clock()
        return {
            "window_s": self.window_s,
            "peers": len(self._known_peers),
            "sessions": len(self._sessions),
            "kv_quant": self.kv_quant,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "pool_page_seconds": round(self.pool_page_seconds, 4),
            "unattributed_page_seconds": round(self.unattributed_page_seconds, 4),
            "cache_byte_seconds": round(self.cache_byte_seconds, 1),
            "peer_overflows": self.peer_overflows,
            "noisy_events": self.noisy_events,
            "top": self._top_locked(k),
            "live_sessions": [
                {
                    "key": s.key,
                    "peer": s.peer,
                    "trace_id": s.trace_id,
                    "age_s": round(now - s.opened_t, 3),
                    "page_rate": round(s.page_rate, 4),
                    **{f: round(s.totals[f], 4) for f in USAGE_FIELDS},
                    **derive_efficiency(s.totals),
                }
                for s in list(self._sessions.values())[:k]
            ],
        }

    def digest(self, k: int = 3) -> dict:
        """Compact per-peer digest riding the DHT announce (size-limited:
        peer ids clipped, top-3 only)."""
        with self._lock:
            self._settle_locked(self._clock())
            totals = self._peer_totals_locked()
            page_s = sum(u["page_seconds"] for u in totals.values())
            compute_s = sum(u["compute_seconds"] for u in totals.values())
            top = self._top_locked(k)
        return {
            "peers": len(totals),
            "sessions": len(self._sessions),
            "page_s": round(page_s, 2),
            "compute_s": round(compute_s, 2),
            "cache_byte_s": round(self.cache_byte_seconds, 1),
            "noisy": self.noisy_events,
            "top": [
                [t["peer"][:16], t["share"], round(t["page_s"], 2)] for t in top
            ],
        }

    # ------------------------------------------------- metric / flight hooks

    _flight = None  # a FlightRecorder: attached, or made on first use

    def attach_flight(self, recorder) -> None:
        self._flight = recorder

    def _flight_record(self, evidence: dict, snapshot: dict) -> None:
        try:
            if self._flight is None:
                from petals_tpu_torch.telemetry.flight import FlightRecorder

                self._flight = FlightRecorder(path=os.environ.get("PETALS_TPU_FLIGHT"))
            self._flight.record("noisy_neighbor", ledger=snapshot, **evidence)
        except Exception as e:  # evidence filing must never fail the detector
            logger.debug(f"flight record of a noisy neighbor failed: {e!r}")


# ---------------------------------------------------------------- singleton

_LEDGER: Optional[ResourceLedger] = None
_LEDGER_LOCK = threading.Lock()


def get_ledger() -> ResourceLedger:
    """Process-wide ledger (double-checked lock, like ``get_registry``).
    Window/threshold knobs read the environment once at first touch."""
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = ResourceLedger(
                    window_s=float(os.environ.get("PETALS_TPU_LEDGER_WINDOW_S", "30")),
                    noisy_share=float(os.environ.get("PETALS_TPU_NOISY_SHARE", "0.5")),
                    noisy_cooldown_s=float(
                        os.environ.get("PETALS_TPU_NOISY_COOLDOWN_S", "5")
                    ),
                )
    return _LEDGER


__all__ = [
    "ANON_PEER",
    "OVERFLOW_PEER",
    "DRF_RESOURCES",
    "USAGE_FIELDS",
    "ResourceLedger",
    "derive_efficiency",
    "get_ledger",
    "normalize_peer",
]
