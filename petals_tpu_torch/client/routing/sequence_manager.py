"""The client's router (petals_tpu/client/routing/sequence_manager.py:139-739).

Keeps a DHT-refreshed view of the swarm and builds server chains:

- ``mode="min_latency"`` (inference): Dijkstra over (block, serving peer)
  nodes whose edge costs combine peer-to-peer RTT, per-block decode cost
  (1 / inference throughput) and a penalty for servers whose KV cache can't
  fit the session. The client->first-server RTT is our own ping; a
  server->server RTT is the source server's announced ``next_pings``.
- ``mode="max_throughput"`` (training): per-span weighted random choice so
  load spreads across the swarm.

Failures ban a peer with a streak-scaled timeout; successes reset the
streak. Congestion blame (a peer whose queue wait dominates its hop) adds a
decaying penalty; prompt-prefix affinity breaks near-ties deterministically.
Integrity blame (a peer whose replies diverged from their fused
fingerprints, ``report_integrity``) adds ``INTEGRITY_PENALTY_S`` for
``INTEGRITY_WINDOW_S``, as does a quarantine a server announces in
``ServerInfo.integrity``. Bans, congestion and integrity penalties and route
builds count into the telemetry registry, as petals_tpu's do.
"""

from __future__ import annotations

import asyncio
import heapq
import logging
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.routing.sequence_info import RemoteSequenceInfo
from petals_tpu_torch.data_structures import ModuleUID, PeerID, RemoteSpanInfo
from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.rpc.client import RpcClient
from petals_tpu_torch.rpc.pool import ConnectionPool
from petals_tpu_torch.telemetry import instruments as tm
from petals_tpu_torch.utils.dht_utils import ModuleDirectory
from petals_tpu_torch.utils.ping import PingAggregator
from petals_tpu_torch.utils.random_utils import sample_up_to
from petals_tpu_torch.utils.version import incompatibility_error, is_compatible

logger = logging.getLogger(__name__)

CACHE_MISS_PENALTY = 10.0  # seconds added when a server's KV cache can't fit us
# the discount of a peer that holds a session's migrated KV (``prefer_peers``):
# a repair lands there and adopts it, with no KV bytes on the client's link
PREFER_PEER_BONUS_S = 10.0
# Disaggregated serving (phase tiers): when a route is built FOR a phase
# ("prefill" heavy prompt processing / "decode" token generation), a replica
# announcing the matching tier gets a discount and a mismatched specialist
# gets a surcharge, while generalists (and pre-tier servers announcing
# nothing) score unchanged. Sized between the congestion and integrity
# penalties: strong enough to pull phase traffic onto its tier against RTT
# noise, weak enough that a quarantined or capacity-missing specialist still
# loses to a healthy generalist (INTEGRITY_PENALTY_S and CACHE_MISS_PENALTY
# dominate).
PHASE_TIER_BONUS_S = 2.0
PHASE_TIER_MISMATCH_S = 2.0
# Soft routing penalty for a queue-dominated server (report_congestion):
# scaled by the observed queue share, decaying after CONGESTION_WINDOW_S.
# Sized like a bad WAN RTT — enough to flip near-ties toward an idle
# replica, far below CACHE_MISS_PENALTY so it never overrides capacity.
CONGESTION_PENALTY_S = 0.05
CONGESTION_WINDOW_S = 30.0
# Hard routing penalty for an integrity-divergent server (report_integrity):
# a replica whose replies disagree with their own fused fingerprints is
# producing WRONG tokens, not slow ones, so the penalty dominates every
# latency signal short of a missing block. Decaying (not a hard ban), so a
# transient wire fault heals without an unban step, and long-windowed,
# because correctness evidence does not go stale the way queue depth does.
INTEGRITY_PENALTY_S = 5.0
INTEGRITY_WINDOW_S = 120.0
# Minimum spacing between congestion-triggered routing refreshes
# (request_refresh): one backlogged open is enough evidence that the cached
# swarm view is stale, but a burst of them must collapse to a single DHT
# fetch, not a stampede.
REFRESH_BACKOFF_S = 2.0
# Prompt-prefix affinity amplitude (see _edge_cost): must dominate
# noise-level cost differences between near-equal replicas or identical
# prompts scatter and never share a prefix cache; must stay below REAL
# routing signal (tens-of-ms WAN RTT gaps, CACHE_MISS_PENALTY).
#
# The amplitude ADAPTS to the MEASURED ping noise (round 5; the flat 5 ms
# constant was measured insufficient — benchmarks/affinity_noise.py: at a
# realistic 0.67 ms smoothed-ping jitter over 3 replicas, convergence was
# only ~85%): amplitude = clip(30 * sigma_ema, 5 ms, 25 ms), where
# sigma_ema comes from the ping aggregator's per-peer deviation tracking
# (utils/ping.py noise_s). Quiet networks keep the minimal 5 ms bias; noisy
# networks widen it — exactly when the RTT estimates can't distinguish
# replicas at that scale anyway, so the larger bias costs nothing real.
AFFINITY_JITTER_S = 5e-3  # floor (quiet networks)
AFFINITY_JITTER_MAX_S = 25e-3  # cap: never override a >25 ms-better replica
AFFINITY_NOISE_MULT = 30.0  # sized by the measured sweep (benchmarks/affinity_noise.py)


def _affinity01(seed: int, peer_id) -> float:
    """Deterministic [0, 1) from (seed, peer): same prompt prefix -> same
    replica preference on every client, every session."""
    import hashlib

    h = hashlib.blake2b(
        seed.to_bytes(8, "big", signed=False) + peer_id.to_string().encode(),
        digest_size=8,
    )
    return int.from_bytes(h.digest(), "big") / 2**64


def affinity_amplitude(noise_s: float) -> float:
    """Adaptive amplitude from the measured smoothed-ping jitter (see the
    constants above)."""
    return min(max(AFFINITY_NOISE_MULT * noise_s, AFFINITY_JITTER_S), AFFINITY_JITTER_MAX_S)


def _affinity_jitters(seed: Optional[int], amplitude: float = AFFINITY_JITTER_S):
    """Per-peer jitter, memoized for one route computation (the Dijkstra
    relaxes each peer many times; the hash depends only on (seed, peer))."""
    if seed is None:
        return lambda peer_id: 0.0
    cache: Dict = {}

    def jitter(peer_id) -> float:
        val = cache.get(peer_id)
        if val is None:
            val = cache[peer_id] = amplitude * _affinity01(seed, peer_id)
        return val

    return jitter
DEFAULT_RTT = 0.01


class MissingBlocksError(RuntimeError):
    def __init__(self, blocks):
        super().__init__(
            f"No servers are currently hosting blocks {blocks} (swarm may still be starting up)"
        )


class RemoteSequenceManager:
    def __init__(self):
        raise RuntimeError("Use `await RemoteSequenceManager.create(...)`")

    @classmethod
    async def create(
        cls,
        config: ClientConfig,
        block_uids: Sequence[ModuleUID],
        *,
        dht: Optional[DHTNode] = None,
        rtt_fn: Optional[Callable[[Optional[PeerID], PeerID], float]] = None,
    ) -> "RemoteSequenceManager":
        self = object.__new__(cls)
        self.config = config
        self.block_uids = tuple(block_uids)
        self._owns_dht = dht is None
        if dht is None:
            dht = await DHTNode.create(initial_peers=config.initial_peers, client_mode=True)
        self.dht = dht
        self.directory = ModuleDirectory(dht)
        self.state = RemoteSequenceInfo.make_empty(self.block_uids)
        # the client's inference-plane pool authenticates with the DHT node's
        # identity: servers see a proven id and prove theirs back
        self.pool = ConnectionPool(identity=dht.identity, connect_timeout=config.connect_timeout)
        self._peer_infos: Dict[PeerID, object] = {}  # peer -> latest ServerInfo
        if rtt_fn is None:
            self.ping_aggregator = PingAggregator(self.pool)
            rtt_fn = self._default_rtt
        else:
            self.ping_aggregator = None
        self.rtt_fn = rtt_fn
        # measured smoothed-ping jitter, sizing the prefix-affinity amplitude
        # (affinity_amplitude above); tests/benchmarks override to inject noise
        self.rtt_noise_fn: Callable[[], float] = (
            self.ping_aggregator.noise_s if self.ping_aggregator is not None else (lambda: 0.0)
        )
        self._banned: Dict[PeerID, Tuple[float, int]] = {}  # peer -> (banned_until, streak)
        # soft congestion blame from the client-side span profiler: a peer
        # whose queue-wait dominates its hop wall gets a decaying routing
        # penalty (peer -> (expires_monotonic, queue_share)) — steering, not
        # the hard hammer of a ban
        self._congestion: Dict[PeerID, Tuple[float, float]] = {}
        self._integrity: Dict[PeerID, float] = {}  # peer -> penalty expiry (monotonic)
        self._last_refresh_req = 0.0  # monotonic time of last request_refresh
        self._refresh_task: Optional[asyncio.Task] = None
        self._update_lock = asyncio.Lock()
        self._update_task = asyncio.create_task(self._update_loop())
        return self

    # ------------------------------------------------------------------ state upkeep

    def _default_rtt(self, src: Optional[PeerID], dst: PeerID) -> float:
        """Edge RTTs for min-latency routing (reference
        sequence_manager.py:241-266): the client->first-server hop uses our own
        ping measurements; server->server hops use the SOURCE server's
        published ``next_pings`` — the client never sees those links itself."""
        if src is None:
            return self.ping_aggregator.rtt(dst, DEFAULT_RTT)
        info = self._peer_infos.get(src)
        next_pings = getattr(info, "next_pings", None)
        if next_pings:
            rtt = next_pings.get(dst.to_string())
            if rtt is not None and math.isfinite(rtt):
                return float(rtt)
        return DEFAULT_RTT

    async def update(self) -> None:
        async with self._update_lock:
            infos = await self.directory.fetch(self.block_uids, active_adapter=self.config.active_adapter)
            infos = self._apply_allow_block_lists(infos)
            self.state.update_(infos)
            self._peer_infos = {
                span.peer_id: span.server_info for span in self.state.spans_by_priority
            }
            self._prune_expired_bans()
            await self._ping_candidates()

    async def _ping_candidates(self) -> None:
        """Measure RTT to a sample of chain-head candidates so min_latency
        routing has real edge costs (reference sequence_manager.py:340-386)."""
        if self.ping_aggregator is None or not self.state.spans_by_priority:
            return
        candidates = []
        for span in self.state.spans_by_priority:
            addr = self.directory.addr_of(span.peer_id)
            if addr is not None:
                candidates.append(addr)
        candidates = sample_up_to(candidates, self.config.max_pinged)
        if candidates:
            try:
                await asyncio.wait_for(self.ping_aggregator.ping(candidates), 10.0)
            except Exception as e:
                logger.debug(f"Ping round failed: {e}")

    def _apply_allow_block_lists(self, infos):
        allowed = set(self.config.allowed_servers or [])
        blocked = set(self.config.blocked_servers or [])
        if not allowed and not blocked:
            return infos
        out = []
        for info in infos:
            if info is None:
                out.append(None)
                continue
            servers = {
                pid: si
                for pid, si in info.servers.items()
                if (not allowed or pid.to_string() in allowed) and pid.to_string() not in blocked
            }
            info.servers = servers
            out.append(info if servers else None)
        return out

    def request_refresh(self) -> None:
        """Congestion-triggered routing refresh, rate-limited.

        A session that just waited out a lane backlog has direct evidence the
        cached swarm view is stale: capacity announced AFTER the last periodic
        update — an autoscaler scale-out, say — stays invisible for up to
        ``update_period`` seconds, typically far longer than the backlog it
        was spawned to absorb.  Fire-and-forget; bursts collapse via
        REFRESH_BACKOFF_S and the update lock.
        """
        now = time.monotonic()
        if now - self._last_refresh_req < REFRESH_BACKOFF_S:
            return
        self._last_refresh_req = now
        self._refresh_task = asyncio.ensure_future(self._refresh_once())

    async def _refresh_once(self) -> None:
        try:
            await self.update()
        except Exception as e:
            logger.debug(f"Congestion-triggered refresh failed: {e}")

    async def _update_loop(self) -> None:
        while True:
            try:
                await self.update()
            except Exception as e:
                logger.warning(f"Routing update failed: {e}")
            await asyncio.sleep(self.config.update_period)

    async def ensure_ready(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while self.state.last_updated_time is None or not self.state.spans_by_priority:
            await self.update()
            if self.state.spans_by_priority:
                return
            if time.monotonic() > deadline:
                raise MissingBlocksError(list(range(len(self.block_uids))))
            await asyncio.sleep(1.0)

    # ------------------------------------------------------------------ bans

    def on_request_failure(self, peer_id: Optional[PeerID]) -> None:
        if peer_id is None:
            return
        _, streak = self._banned.get(peer_id, (0.0, 0))
        duration = min(self.config.ban_timeout * (2**streak), 300.0)
        # ±25% jitter AFTER the cap: a swarm of clients banning the same dead
        # peer would otherwise all unban (and re-probe it) in lockstep — the
        # cap would re-synchronize long streaks if jitter came first
        duration *= random.uniform(0.75, 1.25)
        self._banned[peer_id] = (time.monotonic() + duration, streak + 1)
        tm.PEER_BANS.inc()
        logger.debug(f"Banned {peer_id} for {duration:.1f}s (streak {streak + 1})")

    def on_request_success(self, peer_id: PeerID) -> None:
        self._banned.pop(peer_id, None)

    def _is_banned(self, peer_id: PeerID) -> bool:
        entry = self._banned.get(peer_id)
        if entry is None:
            return False
        until, streak = entry
        if time.monotonic() >= until:
            # ban expired; keep the streak so repeat offenders get longer bans
            return False
        return True

    def _prune_expired_bans(self) -> None:
        """Drop entries whose ban lapsed long ago: the streak memory is only
        worth keeping for recent offenders, not for the life of the client."""
        now = time.monotonic()
        grace = max(20 * self.config.ban_timeout, 600.0)
        self._banned = {
            pid: (until, streak)
            for pid, (until, streak) in self._banned.items()
            if now - until <= grace
        }
        self._congestion = {
            pid: (expires, share)
            for pid, (expires, share) in self._congestion.items()
            if now < expires
        }

    # -------------------------------------------------------------- congestion

    def report_congestion(
        self, peer_id: PeerID, queue_share: float, *, window_s: float = CONGESTION_WINDOW_S
    ) -> None:
        """Hop-level blame from the client-side critical-path profiler
        (InferenceSession): ``queue_share`` of this peer's recent hop wall
        was spent queue-waiting. The penalty decays after ``window_s`` so a
        server that drains its backlog is forgiven without any unban step."""
        share = min(max(float(queue_share), 0.0), 1.0)
        self._congestion[peer_id] = (time.monotonic() + window_s, share)
        tm.CONGESTION_PENALTIES.inc()
        logger.debug(
            f"Congestion blame on {peer_id}: queue share {share:.0%} "
            f"for {window_s:.0f}s"
        )

    def _congestion_penalty(self, peer_id) -> float:
        entry = self._congestion.get(peer_id)
        if entry is None:
            return 0.0
        expires, share = entry
        if time.monotonic() >= expires:
            self._congestion.pop(peer_id, None)
            return 0.0
        return CONGESTION_PENALTY_S * share

    # -------------------------------------------------------------- integrity

    def report_integrity(self, peer_id: PeerID, *, window_s: float = INTEGRITY_WINDOW_S) -> None:
        """Hard blame from the integrity observatory (the session's
        fingerprint cross-check or a canary prober): this peer's replies
        diverged from their own fused fingerprints. Route builds avoid it
        for ``window_s`` unless no healthy replica covers its blocks."""
        self._integrity[peer_id] = time.monotonic() + window_s
        tm.INTEGRITY_PENALTIES.inc()
        logger.warning(f"Integrity blame on {peer_id}: divergent replies, penalized for {window_s:.0f}s")

    def _integrity_penalty(self, peer_id, info) -> float:
        """``INTEGRITY_PENALTY_S`` while a blame lasts, plus as much again for
        a quarantine the server announces (a canary prober anywhere in the
        swarm flagged it), so clients that never talked to it steer off."""
        penalty = 0.0
        expires = self._integrity.get(peer_id)
        if expires is not None:
            if time.monotonic() >= expires:
                self._integrity.pop(peer_id, None)
            else:
                penalty += INTEGRITY_PENALTY_S
        integ = getattr(info, "integrity", None)
        if isinstance(integ, dict) and integ.get("quarantined"):
            penalty += INTEGRITY_PENALTY_S
        return penalty

    # ------------------------------------------------------------------ sequences

    async def refresh_server_infos(
        self, peer_ids: Optional[Sequence[PeerID]] = None, *, timeout: float = 5.0
    ) -> None:
        """Refresh perishable server state via direct ``rpc_info`` calls
        (reference sequence_manager.py:423-466): DHT announces can be a whole
        update_period stale, but cache_tokens_left moves with every session a
        server admits — cache-aware routing needs the live number."""
        if peer_ids is None:
            peer_ids = list(self._peer_infos)
        wanted = {p for p in peer_ids if not self._is_banned(p)}
        # refresh in ROUTING-PREFERENCE order (spans_by_priority), not a random
        # sample: the server Dijkstra is about to pick must be among the ones
        # refreshed, or the stale-cache failure this exists to prevent returns
        ordered = [s.peer_id for s in self.state.spans_by_priority if s.peer_id in wanted]
        ordered += [p for p in wanted if p not in set(ordered)]
        limit = max(self.config.max_pinged * 2, 1)
        if len(ordered) > limit:
            logger.debug(
                f"rpc_info refresh capped at {limit} of {len(ordered)} candidates"
            )
        targets = ordered[:limit]

        async def fetch(peer_id):
            try:
                stub = await self.get_stub(peer_id)
                return peer_id, await stub.call("ptu.info", {})
            except Exception as e:
                logger.debug(f"rpc_info from {peer_id} failed: {e}")
                return peer_id, None

        if not targets:  # e.g. every known peer is version-filtered or banned
            return
        # collective budget: one dead-but-not-yet-banned peer must not stall a
        # session open for its whole connect timeout
        tasks = [asyncio.ensure_future(fetch(p)) for p in targets]
        done, pending = await asyncio.wait(tasks, timeout=timeout)
        for task in pending:
            task.cancel()
        for task in done:
            peer_id, info = task.result()
            if not isinstance(info, dict):
                continue
            server_info = self._peer_infos.get(peer_id)
            if server_info is None:
                continue
            # update the live ServerInfo objects the router reads (shared with
            # state.spans_*); only fields rpc_info reports fresher than the
            # DHT, and only when well-formed — a malformed reply from one
            # server must not abort routing (same rule as ServerInfo.from_tuple)
            try:
                version = info.get("version")
                if not is_compatible(version):
                    # a server upgraded/downgraded across a compatibility line
                    # since its DHT announce. Recording the version only takes
                    # effect at the NEXT spans recompute, so also ban the peer
                    # — the in-flight make_sequence must not route through it
                    # (forward/backward have no handshake backstop)
                    server_info.version = version
                    self.on_request_failure(peer_id)
                    logger.warning(incompatibility_error(version, peer=f"server {str(peer_id)[:16]}…"))
                    continue
                tokens = info.get("cache_tokens_available")
                if tokens is not None:
                    server_info.cache_tokens_left = int(tokens)
                for field in ("throughput", "inference_rps", "forward_rps"):
                    if info.get(field) is not None:
                        setattr(server_info, field, float(info[field]))
            except (TypeError, ValueError) as e:
                logger.debug(f"Malformed rpc_info from {peer_id}: {e}")

    async def make_sequence(
        self,
        start_index: int = 0,
        end_index: Optional[int] = None,
        *,
        mode: str = "min_latency",
        cache_tokens_needed: Optional[int] = None,
        affinity_seed: Optional[int] = None,
        prefer_peers: Optional[Sequence[PeerID]] = None,
        phase: Optional[str] = None,
    ) -> List[RemoteSpanInfo]:
        end_index = end_index if end_index is not None else len(self.block_uids)
        if self.state.last_updated_time is None:
            await self.ensure_ready()

        async def refresh_for_cache():
            # session-open path: the cache-miss penalty is only as good as the
            # freshness of cache_tokens_left
            if cache_tokens_needed is None:
                return
            candidates = {
                span.peer_id
                for i in range(start_index, end_index)
                for span in self._usable_spans_for_block(i)
            }
            await self.refresh_server_infos(list(candidates))

        await refresh_for_cache()

        if mode == "min_latency":
            sequence = self._make_sequence_min_latency(
                start_index, end_index, cache_tokens_needed, affinity_seed,
                prefer_peers=prefer_peers, phase=phase,
            )
        elif mode == "max_throughput":
            sequence = self._make_sequence_max_throughput(start_index, end_index)
        else:
            raise ValueError(f"Unknown routing mode {mode!r}")

        if not sequence:
            # one forced refresh before giving up; update() rebuilds spans
            # from (possibly stale) DHT announces, so live cache numbers must
            # be re-fetched on top of the fresh snapshot
            await self.update()
            await refresh_for_cache()
            sequence = (
                self._make_sequence_min_latency(
                    start_index, end_index, cache_tokens_needed, affinity_seed,
                    prefer_peers=prefer_peers, phase=phase,
                )
                if mode == "min_latency"
                else self._make_sequence_max_throughput(start_index, end_index)
            )
        if not sequence:
            missing = [
                i
                for i in range(start_index, end_index)
                if not self._usable_spans_for_block(i)
            ]
            raise MissingBlocksError(missing)

        tm.ROUTE_BUILDS.labels(mode=mode).inc()
        if self.config.show_route:
            route = " => ".join(
                f"{s.peer_id.to_string()[:8]} [{s.start}:{s.end}] ({s.throughput:.1f} rps)"
                for s in sequence
            )
            logger.info(f"Route found: {route}")
        return sequence

    def _usable_spans_for_block(self, block_idx: int) -> List[RemoteSpanInfo]:
        return [
            s for s in self.state.spans_containing_block[block_idx] if not self._is_banned(s.peer_id)
        ]

    def _make_sequence_max_throughput(self, start: int, end: int) -> List[RemoteSpanInfo]:
        """Per-hop weighted random span choice (training load-spreading)."""
        sequence: List[RemoteSpanInfo] = []
        current = start
        while current < end:
            candidates = self._usable_spans_for_block(current)
            if not candidates:
                return []
            weights = [max(s.throughput, 1e-3) for s in candidates]
            chosen = random.choices(candidates, weights=weights, k=1)[0]
            chosen = RemoteSpanInfo(
                peer_id=chosen.peer_id,
                start=current,
                end=min(chosen.end, end),
                server_info=chosen.server_info,
            )
            sequence.append(chosen)
            current = chosen.end
        return sequence

    def _make_sequence_min_latency(
        self, start: int, end: int, cache_tokens_needed: Optional[int],
        affinity_seed: Optional[int] = None,
        prefer_peers: Optional[Sequence[PeerID]] = None,
        phase: Optional[str] = None,
    ) -> List[RemoteSpanInfo]:
        """Dijkstra over (block, peer) states; edge = RTT + per-block decode cost
        (+ cache-miss penalty), mirroring reference :177-300."""
        import itertools

        jitter = _affinity_jitters(affinity_seed, affinity_amplitude(self.rtt_noise_fn()))
        tiebreak = itertools.count()  # heap entries: (cost, counter, block, peer)
        heap: List[Tuple] = [(0.0, next(tiebreak), start, None)]
        best: Dict[Tuple[int, Optional[PeerID]], float] = {(start, None): 0.0}
        parents: Dict[Tuple[int, Optional[PeerID]], Tuple] = {}

        result_key = None
        while heap:
            cost, _, block, peer = heapq.heappop(heap)
            key = (block, peer)
            if cost > best.get(key, float("inf")):
                continue
            if block >= end:
                result_key = key
                break
            for span in self._usable_spans_for_block(block):
                info = span.server_info
                next_block = min(span.end, end)
                edge = self._edge_cost(
                    peer, span.peer_id, info, next_block - block, cache_tokens_needed,
                    affinity_jitter=jitter(span.peer_id),
                    prefer_peers=prefer_peers, phase=phase,
                )
                nkey = (next_block, span.peer_id)
                ncost = cost + edge
                if ncost < best.get(nkey, float("inf")):
                    best[nkey] = ncost
                    parents[nkey] = (key, span, next_block)
                    heapq.heappush(heap, (ncost, next(tiebreak), next_block, span.peer_id))

        if result_key is None:
            return []
        # reconstruct
        sequence: List[RemoteSpanInfo] = []
        key = result_key
        while key in parents:
            prev_key, span, next_block = parents[key]
            sequence.append(
                RemoteSpanInfo(
                    peer_id=span.peer_id,
                    start=prev_key[0],
                    end=next_block,
                    server_info=span.server_info,
                )
            )
            key = prev_key
        sequence.reverse()
        return sequence

    def _edge_cost(
        self, prev_peer, peer_id, info, n_blocks: int, cache_tokens_needed: Optional[int],
        *, affinity_jitter: float = 0.0,
        prefer_peers: Optional[Sequence[PeerID]] = None,
        phase: Optional[str] = None,
    ) -> float:
        """One chain hop's cost: RTT + per-block decode cost + cache-miss
        penalty, the edge model shared by the Dijkstra and
        ``estimate_chain_latency``.

        ``affinity_jitter`` (prompt-prefix affinity, up to AFFINITY_JITTER_S
        = 5 ms): a deterministic per-(prompt, peer) bias that consistently
        resolves choices between replicas whose measured costs differ by
        less than a few ms (noise scale), so sessions with the same prompt
        prefix pick the same replica and hit its prefix cache
        (server/prefix_cache.py), while different prompts spread load. It
        CAN flip a genuinely ≤5 ms-better replica — accepted: a prefix-cache
        hit repays that thousandfold by skipping the shared prefill."""
        rps = info.inference_rps or info.throughput or 1.0
        edge = self.rtt_fn(prev_peer, peer_id) + n_blocks / max(rps, 1e-3)
        if (
            cache_tokens_needed is not None
            and info.cache_tokens_left is not None
            and info.cache_tokens_left < cache_tokens_needed
        ):
            edge += CACHE_MISS_PENALTY
        edge += self._congestion_penalty(peer_id) + self._integrity_penalty(peer_id, info)
        edge += affinity_jitter
        if phase is not None:
            # disaggregated serving: pull this route onto replicas declaring
            # the matching tier, push it off mismatched specialists; servers
            # announcing no tier (or "generalist") score unchanged, so mixed
            # and legacy swarms route exactly as before
            tier = getattr(info, "phase_tier", None)
            if tier in ("prefill", "decode"):
                if tier == phase:
                    edge = max(edge - PHASE_TIER_BONUS_S, 0.0)
                else:
                    edge += PHASE_TIER_MISMATCH_S
        if prefer_peers is not None and peer_id in prefer_peers:
            # this peer holds the session's migrated KV (clamped: the
            # Dijkstra needs non-negative edges)
            edge = max(edge - PREFER_PEER_BONUS_S, 0.0)
        return edge

    def estimate_chain_latency(
        self, chain: List[RemoteSpanInfo], cache_tokens_needed: Optional[int] = None,
        phase: Optional[str] = None,
    ) -> float:
        """A chain's estimated per-token latency under the Dijkstra's cost
        model (``_edge_cost``), each span's ServerInfo taken from the
        current routing state, so that a chain chosen minutes ago is scored
        against today's swarm (route upgrades compare two chains by it)."""
        cost, prev = 0.0, None
        by_block = self.state.spans_containing_block
        for span in chain:
            info = span.server_info
            if span.start < len(by_block):
                for cand in by_block[span.start]:
                    if cand.peer_id == span.peer_id:
                        info = cand.server_info
                        break
            cost += self._edge_cost(prev, span.peer_id, info, span.end - span.start, cache_tokens_needed, phase=phase)
            prev = span.peer_id
        return cost

    # ------------------------------------------------------------------ stubs

    def addr_of(self, peer_id: PeerID) -> Optional[PeerAddr]:
        return self.directory.addr_of(peer_id)

    async def get_stub(self, peer_id: PeerID) -> RpcClient:
        addr = self.addr_of(peer_id)
        if addr is None:
            raise KeyError(f"No known contact address for {peer_id}")
        return await self.pool.get_addr(addr)

    async def shutdown(self) -> None:
        self._update_task.cancel()
        try:
            await self._update_task
        except asyncio.CancelledError:
            pass
        if self._refresh_task is not None:
            self._refresh_task.cancel()
            try:
                await self._refresh_task
            except asyncio.CancelledError:
                pass
        await self.pool.close()
        if self._owns_dht:
            await self.dht.shutdown()
