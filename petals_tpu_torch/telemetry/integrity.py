"""Swarm integrity observatory: client cross-checks, canary probing, and
divergence quarantine (the port's copy of petals_tpu/telemetry/integrity.py).

Three detection planes share one primitive — the seeded low-rank activation
fingerprint of :mod:`petals_tpu_torch.ops.fingerprint`:

* **Client cross-check** (:class:`IntegrityMonitor`): every inference reply
  carries the server's fused digest in ``step_meta["fp"]``; the client
  recomputes the same digest from the hidden state it actually received and
  compares within the transport tolerance. A server whose reply disagrees
  with its own fused fingerprint corrupted (or had corrupted) the activation
  AFTER the compiled step — exactly the wire/serialization/buggy-replica
  failure the fingerprint was fused to catch. The monitor also keeps a
  position ring so a repair or migration that replays positions on an
  adopting replica must reproduce the original digest stream within the
  cross-replica (quantization) tolerance.

* **Canary probing** (:class:`CanaryProber`): a background loop replays
  seeded golden inputs against every replica of a span and compares the
  returned logit/hidden fingerprints by quorum. The majority cluster is
  truth; outliers are quarantined. Probing needs no model weights on the
  prober — digests of the same golden input through the same blocks must
  agree across replicas within the quantization tolerance.

* **Quarantine** (:class:`QuarantineRegistry`): a process-local decaying
  registry of divergent peers. Routing consults it (hard penalty), the
  announce plane publishes it (``ServerInfo.integrity``), and an
  autoscaler may drain and replace quarantined replicas.

Digest values never become metric label values (unbounded cardinality); evidence rides
the journal (``integrity_divergence`` events carry both ``digest_hex``
forms) and the flight recorder.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from petals_tpu_torch.ops import fingerprint as fp_ops
from petals_tpu_torch.telemetry import instruments as tm
from petals_tpu_torch.telemetry.journal import get_journal

logger = logging.getLogger(__name__)

# How many (span, position) -> digest entries the client keeps for replay
# continuity. Sized for the repair window: a mid-stream repair replays at
# most the uncommitted tail of the session, far below this.
CONTINUITY_RING = 512

# Quarantine duration. Long enough for the autoscaler (tick period ~10s in
# the benches, minutes in production) to observe the quarantine and act;
# short enough that a false positive heals itself without operator action.
QUARANTINE_WINDOW_S = 300.0

# A quorum needs a strict majority to name the outlier. With two replicas a
# disagreement is evidence of *a* fault but not of *which* replica — both
# get reported, neither quarantined.
MIN_QUORUM = 3


def _now() -> float:
    return time.monotonic()


# --------------------------------------------------------------- quarantine


class QuarantineRegistry:
    """Decaying set of integrity-divergent peers (process-local).

    Thread-safe: the canary loop, the client monitor, and the health
    renderer all touch it from different threads.
    """

    def __init__(self, *, window_s: float = QUARANTINE_WINDOW_S):
        self._window_s = window_s
        self._lock = threading.Lock()
        self._entries: Dict[str, Tuple[float, str]] = {}  # peer -> (expires, reason)

    def quarantine(self, peer_id: str, *, reason: str = "divergence") -> None:
        with self._lock:
            self._entries[str(peer_id)] = (_now() + self._window_s, reason)
            n = len(self._entries)
        tm.INTEGRITY_QUARANTINED.set(n)
        logger.warning(f"Integrity quarantine: {peer_id} ({reason})")

    def release(self, peer_id: str) -> None:
        with self._lock:
            self._entries.pop(str(peer_id), None)
            n = len(self._entries)
        tm.INTEGRITY_QUARANTINED.set(n)

    def is_quarantined(self, peer_id: str) -> bool:
        return str(peer_id) in self.snapshot()

    def snapshot(self) -> Dict[str, str]:
        """Live ``peer -> reason`` map (expired entries pruned)."""
        now = _now()
        with self._lock:
            self._entries = {
                p: (exp, why) for p, (exp, why) in self._entries.items() if now < exp
            }
            live = {p: why for p, (exp, why) in self._entries.items()}
        tm.INTEGRITY_QUARANTINED.set(len(live))
        return live


_quarantine: Optional[QuarantineRegistry] = None
_quarantine_lock = threading.Lock()


def get_quarantine() -> QuarantineRegistry:
    global _quarantine
    with _quarantine_lock:
        if _quarantine is None:
            _quarantine = QuarantineRegistry()
        return _quarantine


# ------------------------------------------------------------ client monitor


class IntegrityMonitor:
    """Per-session fingerprint cross-check on the client.

    ``verify_step`` is called once per decode step per hop with the server's
    fused digest (``step_meta["fp"]``) and the hidden state the client
    deserialized. Divergence is journaled with both ``digest_hex`` forms,
    flight-recorded, counted, and reported to ``on_divergence`` (wired to
    the sequence manager's hard routing penalty).
    """

    def __init__(
        self,
        *,
        trace_id: Optional[str] = None,
        on_divergence: Optional[Callable[[str], None]] = None,
        flight: Any = None,
    ):
        self.trace_id = trace_id
        self.on_divergence = on_divergence
        self.flight = flight
        self.divergences = 0
        self.checked = 0
        # (start, end, position) -> client-side digest, for replay continuity
        self._ring: "OrderedDict[Tuple[int, int, int], np.ndarray]" = OrderedDict()

    def verify_step(
        self,
        peer_id: str,
        server_fp: Optional[Sequence[float]],
        hidden: np.ndarray,
        *,
        start: int,
        end: int,
        position: int,
        lossy_wire: bool = False,
        quant: str = "none",
        kv_quant: str = "none",
    ) -> bool:
        """True when the reply's digest stream is consistent; False (after
        recording evidence) on divergence. Hops without a fingerprint (old
        servers, whole-prefix cache hits) are skipped, never failed."""
        if server_fp is None:
            return True
        local = fp_ops.fingerprint_output(hidden, hidden.shape[-1])
        remote = np.asarray(list(server_fp), dtype=np.float32)
        if remote.shape != local.shape:
            self._record(peer_id, "client", local, remote, start, end, position,
                         detail="fingerprint shape mismatch")
            return False
        self.checked += 1
        tol = fp_ops.TOL_LOSSY_WIRE if lossy_wire else fp_ops.TOL_TRANSPORT
        ok = fp_ops.fp_close(local, remote, rtol=tol)
        if not ok:
            self._record(peer_id, "client", local, remote, start, end, position,
                         detail="reply disagrees with fused fingerprint")
        else:
            ok = self._check_continuity(
                peer_id, local, start=start, end=end, position=position,
                quant=quant, kv_quant=kv_quant,
            )
        key = (int(start), int(end), int(position))
        self._ring[key] = local
        self._ring.move_to_end(key)
        while len(self._ring) > CONTINUITY_RING:
            self._ring.popitem(last=False)
        return ok

    def _check_continuity(
        self, peer_id: str, local: np.ndarray, *, start: int, end: int,
        position: int, quant: str, kv_quant: str = "none"
    ) -> bool:
        """A replayed position (repair/migration re-drove the span) must
        reproduce the digest the original replica produced, within the
        cross-replica quantization tolerance (widened by ``kv_quant`` when
        either replica stores its paged KV pool quantized — an adopted
        session's cache went through a requantization round trip)."""
        prev = self._ring.get((int(start), int(end), int(position)))
        if prev is None:
            return True
        tol = fp_ops.tolerance_for(quant, kv_quant)
        if fp_ops.fp_close(local, prev, rtol=tol):
            return True
        self._record(
            peer_id, "continuity", local, prev, start, end, position,
            detail="adopting replica broke digest continuity across repair",
        )
        return False

    def _record(
        self, peer_id: str, source: str, local: np.ndarray, remote: np.ndarray,
        start: int, end: int, position: int, *, detail: str
    ) -> None:
        self.divergences += 1
        tm.INTEGRITY_DIVERGENCE.labels(source=source).inc()
        fields = dict(
            peer=str(peer_id),
            source=source,
            span=f"{start}:{end}",
            position=int(position),
            local_digest=fp_ops.digest_hex(local),
            remote_digest=fp_ops.digest_hex(remote),
            detail=detail,
        )
        get_journal().event("integrity_divergence", trace_id=self.trace_id, **fields)
        if self.flight is not None:
            try:
                self.flight.record(
                    "integrity_divergence", trace_id=self.trace_id, **fields
                )
            except Exception:
                pass  # evidence capture must never take down the session
        logger.warning(
            f"Integrity divergence ({source}) on {peer_id} span {start}:{end} "
            f"pos {position}: local {fields['local_digest']} vs remote "
            f"{fields['remote_digest']} — {detail}"
        )
        if self.on_divergence is not None:
            try:
                self.on_divergence(peer_id)
            except Exception:
                pass


# ------------------------------------------------------------- canary prober


class CanaryProber:
    """Replays seeded golden inputs against span replicas and quarantines
    fingerprint outliers by quorum.

    ``probe_fn(peer_id, first_block, n_blocks)`` issues the actual probe
    (the ``ptu.probe`` RPC in production; a direct handler call in the
    single-process benches) and returns the digest as a float list, or
    raises/returns ``None`` on failure. The prober itself is transport- and
    event-loop-agnostic so ``run_health``, servers, and benches can all
    drive it.
    """

    def __init__(
        self,
        probe_fn: Callable[[str, int, int], Optional[Sequence[float]]],
        *,
        quarantine: Optional[QuarantineRegistry] = None,
        tokens: int = 4,
        seed: Optional[int] = None,
        flight: Any = None,
    ):
        self.probe_fn = probe_fn
        self.quarantine = quarantine or get_quarantine()
        self.tokens = int(tokens)
        self.seed = fp_ops.fp_seed() if seed is None else int(seed)
        self.flight = flight
        self.rounds = 0

    def probe_span(
        self,
        span: Tuple[int, int],
        replicas: Sequence[str],
        *,
        quant: str = "none",
        kv_quant: str = "none",
    ) -> Dict[str, Any]:
        """Probe every replica of ``span = (first_block, n_blocks)`` once and
        quarantine quorum outliers. ``quant``/``kv_quant`` are the widest
        weight / paged-KV-pool quantization modes among the replicas — a
        replica serving from a quantized pool legitimately diverges within
        the kv_quant band and must not be named an outlier for it. Returns
        a report dict (also journaled when divergence is found)."""
        self.rounds += 1
        digests: Dict[str, np.ndarray] = {}
        errors: List[str] = []
        for peer in replicas:
            try:
                fp = self.probe_fn(str(peer), span[0], span[1])
            except Exception as e:
                logger.debug(f"Canary probe failed on {peer}: {e}")
                fp = None
            if fp is None:
                tm.INTEGRITY_PROBES.labels(outcome="error").inc()
                errors.append(str(peer))
                continue
            digests[str(peer)] = np.asarray(list(fp), dtype=np.float32)
        outliers, majority = quorum_outliers(
            digests, rtol=fp_ops.tolerance_for(quant, kv_quant)
        )
        for peer in digests:
            outcome = "divergent" if peer in outliers else "ok"
            tm.INTEGRITY_PROBES.labels(outcome=outcome).inc()
        report = {
            "span": f"{span[0]}:{span[0] + span[1]}",
            "probed": sorted(digests),
            "errors": errors,
            "outliers": sorted(outliers),
            "quorum": len(majority),
        }
        for peer in outliers:
            tm.INTEGRITY_DIVERGENCE.labels(source="canary").inc()
            self.quarantine.quarantine(peer, reason=f"canary outlier {report['span']}")
            ref = next((digests[p] for p in majority), None)
            fields = dict(
                peer=peer,
                source="canary",
                span=report["span"],
                local_digest=fp_ops.digest_hex(digests[peer]),
                remote_digest=fp_ops.digest_hex(ref) if ref is not None else "",
                detail=f"quorum outlier ({len(majority)} replicas agree)",
            )
            get_journal().event("integrity_divergence", **fields)
            if self.flight is not None:
                try:
                    self.flight.record("integrity_divergence", **fields)
                except Exception:
                    pass  # evidence capture must never take down the prober
        return report


def quorum_outliers(
    digests: Dict[str, np.ndarray], *, rtol: float
) -> Tuple[List[str], List[str]]:
    """Cluster replica digests by ``fp_close`` agreement and return
    ``(outliers, majority_cluster_members)``.

    A strict majority cluster names the outliers; without one (two replicas
    disagreeing, or a three-way split) nobody is quarantined — divergence
    without attribution is reported by the caller's error/ok counts only.
    """
    peers = list(digests)
    if len(peers) < 2:
        return [], peers
    clusters: List[List[str]] = []
    for peer in peers:
        for cluster in clusters:
            if fp_ops.fp_close(digests[peer], digests[cluster[0]], rtol=rtol):
                cluster.append(peer)
                break
        else:
            clusters.append([peer])
    clusters.sort(key=len, reverse=True)
    majority = clusters[0]
    if len(peers) >= MIN_QUORUM and len(majority) * 2 > len(peers):
        outliers = [p for p in peers if p not in majority]
        return outliers, majority
    return [], majority if len(clusters) == 1 else []


# ------------------------------------------------------------- announce cap


def cap_announce_payload(payload: dict, *, max_bytes: int = 2048) -> dict:
    """Bound an announce-bound dict (``telemetry``/``integrity`` digests ride
    every widely-replicated ServerInfo record). Drops the largest top-level
    entries first until the JSON encoding fits, counting each clip in
    ``telemetry_announce_truncated_total``."""
    import json

    def size(d: dict) -> int:
        return len(json.dumps(d, default=str, separators=(",", ":")))

    if size(payload) <= max_bytes:
        return payload
    out = dict(payload)
    by_size = sorted(out, key=lambda k: size({k: out[k]}), reverse=True)
    for key in by_size:
        if size(out) <= max_bytes:
            break
        out.pop(key)
        tm.ANNOUNCE_TRUNCATED.inc()
    return out


__all__ = [
    "CONTINUITY_RING",
    "MIN_QUORUM",
    "QUARANTINE_WINDOW_S",
    "CanaryProber",
    "IntegrityMonitor",
    "QuarantineRegistry",
    "cap_announce_payload",
    "get_quarantine",
    "quorum_outliers",
]
