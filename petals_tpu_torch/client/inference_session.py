"""Client-side autoregressive inference over a chain of servers
(petals_tpu/client/inference_session.py).

- ``_ServerInferenceSession`` drives one server's bidirectional inference
  stream: open with (uids, max_length), then step (hidden, prompts,
  hypo_ids, start_from_position). It records the ``history`` of inputs it
  sent, so a replacement server's KV cache can be rebuilt after a failure.
- ``InferenceSession`` chains per-span sessions across the whole model. On
  a step failure it bans the peer and rebuilds the failed span's range
  only, keeping the healthy sessions and their caches. The replacement is
  seeded, in this order, by adopting the KV the failed server pushed to a
  replica (a ``migrated_to`` redirect: the repair routes there and sends
  ``kv_adopt``, with no KV bytes on the client's link), by importing the
  KV it still exports (``ptu.session_export`` -> ``kv_import``, topped up
  by replaying the steps it missed), or by replaying the recorded history
  through the new span (``_replay_step``).
- With ``use_server_to_server`` each server is told to push its output to
  the next span's session (``push_to``); the client still relays every
  step, and the next server serves whichever copy comes first. After a
  repair, a route upgrade or a handoff, the chain is re-linked through the
  next step's ``push_to``.
- ``route_upgrade_period`` moves a session onto a clearly faster chain by
  live export and import; a session that prefilled on a prefill-tier
  replica hands its KV to a decode-tier one after the first step
  (``_maybe_phase_handoff``: ``ptu.session_handoff`` on the source,
  ``kv_adopt`` at the destination), or goes on where it is.
- ``generate_remote``: over a route of one span covering the whole model
  whose server announces ``server_gen`` (``server_gen_sampling`` for a
  ``sampling`` dict), the server generates a chunk of tokens in one step
  (``step_generate``); the session records the embeddings of the tokens the
  server fed, so a replay rebuilds the same cache. A failure mid-chunk
  tears the route down and repairs it by replay, and the caller goes on
  per token.

Hidden states are CPU tensors on the wire side (``rpc/serialization.py``).

Telemetry (telemetry/, as petals_tpu's session wires it): each server span
keeps a ``HopTrace`` of its steps (client wall, the server's queue /
compute / serialize seconds from ``step_meta``, the billed usage), and
``trace_report()`` turns the hops, closed ones included, into the
session's latency waterfall. ``flight`` (``flight_from_env``: set
``PETALS_TPU_SLO_TTFT_MS`` / ``PETALS_TPU_SLO_TOKEN_MS``) records a step
that breaches an SLO with the waterfall and the critical-path server's
journal excerpt (from its announced ``metrics_port``). ``integrity``, an
``IntegrityMonitor``, checks each reply that carries the server's fused
fingerprint (``step_meta["fp"]``) against the digest of the hidden state
received; a divergence is journaled and blamed on the peer through
``report_integrity``. The journal records ``export_fallback``,
``handoff_fallback`` and ``handoff_complete``.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
import uuid
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

import petals_tpu_torch
from petals_tpu_torch.client.routing.sequence_manager import RemoteSequenceManager
from petals_tpu_torch.data_structures import CHAIN_DELIMITER, PeerID, RemoteSpanInfo
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.rpc.client import StreamCall
from petals_tpu_torch.rpc.serialization import CompressionType, as_tensor, deserialize_array, serialize_array
from petals_tpu_torch.telemetry.flight import flight_from_env, http_journal_fetcher
from petals_tpu_torch.telemetry.integrity import IntegrityMonitor
from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.ledger import derive_efficiency
from petals_tpu_torch.telemetry.spans import MAX_RETIRED_HOPS, HopTrace, build_trace_report
from petals_tpu_torch.telemetry.trace import new_trace_id

logger = logging.getLogger(__name__)

# Minimum server-reported lane-admission wait (seconds) before a session open
# files congestion blame on its own; sub-second waits are scheduling jitter.
OPEN_WAIT_BLAME_S = 0.5
# Floor below which the reported wait is not folded into the hop at all: an
# uncontended acquire still measures a few microseconds.
OPEN_WAIT_FOLD_MIN_S = 0.05
# the first prefill segment hashed for prompt-prefix routing affinity: the
# unit petals_tpu's server-side prefix cache stores
# (petals_tpu/server/prefix_cache.py SEGMENT_TOKENS)
AFFINITY_SEGMENT_TOKENS = 128


class _ServerInferenceSession:
    def __init__(self, span: RemoteSpanInfo, uids: Sequence[str], stream: StreamCall, *,
                 max_length: int, step_timeout: float):
        self.span = span
        self.uids = list(uids)
        self.stream = stream
        self.max_length = max_length
        self.step_timeout = step_timeout
        self.compression = CompressionType.NONE  # create() sets the negotiated codec
        self.position = 0
        # inputs sent so far, as (hidden, hypo_ids) steps: a replay must
        # repeat beam-lane reorders exactly (failover during beam search)
        self.history: List[tuple] = []
        self.closed = False
        self.session_id: Optional[str] = None
        # set after a chain repair: a dict retargets this server's pushes,
        # False stops them; sent with the next step
        self.pending_push_to = None
        self.echoed_trace_id: Optional[str] = None
        # the hop's critical-path account: each step's client wall and the
        # server's step_meta (telemetry/spans.py)
        self.hop = HopTrace(span.peer_id.to_string(), span.start, span.end)
        # the owning InferenceSession's IntegrityMonitor: a reply carrying a
        # fused fingerprint is checked against the hidden state received
        self.monitor: Optional[IntegrityMonitor] = None

    @classmethod
    async def create(
        cls,
        seq_manager: RemoteSequenceManager,
        span: RemoteSpanInfo,
        uids: Sequence[str],
        *,
        max_length: int,
        batch_size: int = 1,
        step_timeout: float = 5 * 60,
        session_id: Optional[str] = None,
        push_to: Optional[dict] = None,
        trace_id: Optional[str] = None,
    ) -> "_ServerInferenceSession":
        stub = await seq_manager.get_stub(span.peer_id)
        stream = await stub.open_stream("ptu.inference")
        compression = CompressionType(seq_manager.config.compression)
        open_msg = {
            "uids": CHAIN_DELIMITER.join(uids),
            "max_length": max_length,
            "batch_size": batch_size,
            "active_adapter": seq_manager.config.active_adapter,
            # "none" must override a lossy server default, so it is always sent
            "compression": compression.value,
            # the server refuses a client across its MAJOR.MINOR line
            "client_version": petals_tpu_torch.__version__,
        }
        if session_id:
            open_msg["session_id"] = session_id
        if push_to:
            open_msg["push_to"] = push_to
        if trace_id:
            # one id for every server span of the session (and its repairs)
            open_msg["trace_id"] = trace_id
        priority = seq_manager.config.session_priority
        if priority is not None:
            open_msg["priority"] = priority
        alloc_timeout = seq_manager.config.alloc_timeout
        if alloc_timeout is not None:
            open_msg["alloc_timeout"] = float(alloc_timeout)
        t_open = time.perf_counter()
        await stream.send(open_msg)
        ack = await stream.recv(timeout=step_timeout)
        open_wall_s = time.perf_counter() - t_open
        if not (isinstance(ack, dict) and ack.get("session_open")):
            raise RuntimeError(f"Unexpected open reply: {ack}")
        self = cls(span, uids, stream, max_length=max_length, step_timeout=step_timeout)
        self.session_id = session_id
        self.compression = compression
        echoed = ack.get("trace_id")
        if isinstance(echoed, str) and echoed:
            self.echoed_trace_id = echoed
        # a lane-admission wait that dominates the open is blamed at once:
        # short sessions never reach the step-cadence blame check
        try:
            open_wait_s = float(ack.get("open_wait_s") or 0.0)
        except (TypeError, ValueError):
            open_wait_s = 0.0
        if open_wait_s >= OPEN_WAIT_FOLD_MIN_S:
            self.hop.record(open_wall_s, {"queue_s": open_wait_s, "total_s": open_wait_s}, tokens=0)
            share = self.hop.queue_share()
            if open_wait_s >= OPEN_WAIT_BLAME_S and share > 0.5:
                seq_manager.report_congestion(span.peer_id, share)
                # the cached swarm view is stale: capacity announced since the
                # last update becomes routable now
                seq_manager.request_refresh()
        return self

    async def import_kv(self, k, v, position: int) -> None:
        """Seed this fresh session's server-side KV from an exported cache
        [blocks, batch, position, hkv, d], before any step."""
        assert self.position == 0 and not self.history, "import_kv only on a fresh session"
        await self.stream.send({
            "kv_import": {"position": int(position)},
            "tensors": {"k": serialize_array(k), "v": serialize_array(v)},
        })
        reply = await self.stream.recv(timeout=self.step_timeout)
        if not reply.get("kv_import") or reply.get("position") != position:
            raise RuntimeError(f"kv_import rejected: {reply}")
        self.position = position

    async def adopt_kv(self, source_session_id: str, position: int) -> None:
        """Seed this fresh session from KV the SERVER already holds (pushed
        there by a draining or handing-off peer, or its own parked copy):
        only ids cross the client's link."""
        assert self.position == 0 and not self.history, "adopt_kv only on a fresh session"
        await self.stream.send({"kv_adopt": {"session_id": source_session_id, "position": int(position)}})
        reply = await self.stream.recv(timeout=self.step_timeout)
        if not reply.get("kv_adopt") or reply.get("position") != position:
            raise RuntimeError(f"kv_adopt rejected: {reply}")
        self.position = position

    async def step(
        self,
        hidden,
        *,
        prompts=None,
        hypo_ids=None,
        start_from_position: Optional[int] = None,
        step_id: Optional[str] = None,
    ) -> torch.Tensor:
        hidden = as_tensor(hidden)
        if start_from_position is not None:
            self._rollback_history(start_from_position)
        comp = self.compression
        msg = {"tensors": {"hidden": serialize_array(hidden, comp)}}
        if step_id is not None:
            msg["step_id"] = step_id
        if self.pending_push_to is not None:
            msg["push_to"] = self.pending_push_to or None
            self.pending_push_to = None
        if prompts is not None:
            msg["tensors"]["prompts"] = serialize_array(prompts, comp)
        if hypo_ids is not None:
            hypo_ids = as_tensor(hypo_ids).to(torch.int64)
            msg["tensors"]["hypo_ids"] = serialize_array(hypo_ids)
        if start_from_position is not None:
            msg["start_from_position"] = int(start_from_position)
        t_rpc = time.perf_counter()
        await self.stream.send(msg)
        reply = await self.stream.recv(timeout=self.step_timeout)
        self.hop.record(time.perf_counter() - t_rpc, reply.get("step_meta"), tokens=int(hidden.shape[1]))
        out = deserialize_array(reply["tensors"]["hidden"])
        self.position = reply["position"]
        meta = reply.get("step_meta") or {}
        if self.monitor is not None and meta.get("fp") is not None:
            # the reply against the server's fused fingerprint: a mismatch
            # means the activation changed after the step program (the wire,
            # serialization, or a lying replica)
            self.monitor.verify_step(
                self.span.peer_id, meta["fp"], out.float().numpy(), start=self.span.start, end=self.span.end,
                position=int(reply["position"]), lossy_wire=self.compression != CompressionType.NONE,
                quant=getattr(self.span.server_info, "quant_type", None) or "none",
            )
        self.history.append((hidden, hypo_ids))
        return out

    async def step_generate(
        self,
        hidden,
        n_tokens: int,
        embed_fn: Callable,
        *,
        start_from_position: Optional[int] = None,
        step_id: Optional[str] = None,
        sampling: Optional[dict] = None,
    ) -> np.ndarray:
        """Feed ``hidden`` and have the server generate ``n_tokens`` tokens
        after it (a whole-model server announcing ``server_gen``): greedy,
        or under a ``gen_sampling`` dict. Returns the token ids [1, n] int64,
        n the count the server answered (it clamps). ``embed_fn(tokens)``
        gives the embeddings of the tokens the server fed itself (all but the
        last), recorded into the history, so a replay onto any server
        rebuilds the same cache."""
        hidden = as_tensor(hidden)
        if start_from_position is not None:
            self._rollback_history(start_from_position)
        msg = {"tensors": {"hidden": serialize_array(hidden, self.compression)}, "gen_tokens": int(n_tokens)}
        if sampling is not None:
            msg["gen_sampling"] = sampling
        if step_id is not None:
            msg["step_id"] = step_id
        if start_from_position is not None:
            msg["start_from_position"] = int(start_from_position)
        t_rpc = time.perf_counter()
        await self.stream.send(msg)
        reply = await self.stream.recv(timeout=self.step_timeout)
        tokens = np.asarray(reply["tokens"], np.int64)[None]
        self.hop.record(time.perf_counter() - t_rpc, reply.get("step_meta"), tokens=int(tokens.shape[1]))
        self.position = reply["position"]
        self.history.append((hidden, None))
        if tokens.shape[1] > 1:
            self.history.append((as_tensor(embed_fn(tokens[:, :-1])), None))
        return tokens

    def _rollback_history(self, new_position: int) -> None:
        self.position = new_position
        kept, total = [], 0
        for h, hypo in self.history:
            if total >= new_position:
                break
            take = min(h.shape[1], new_position - total)
            kept.append((h[:, :take] if take < h.shape[1] else h, hypo))
            total += take
        self.history = kept

    def history_steps(self) -> List[tuple]:
        """The (hidden, hypo_ids) steps fed so far, for failover replay."""
        return list(self.history)

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                await self.stream.end()
            except Exception:
                pass  # the server or the connection may already be gone
            await self.stream.cancel()


class InferenceSession:
    """Whole-model autoregressive session with mid-generation failover."""

    def __init__(self, seq_manager: RemoteSequenceManager, max_length: int, batch_size: int = 1):
        self.seq_manager = seq_manager
        self.max_length = max_length
        self.batch_size = batch_size
        self._sessions: List[_ServerInferenceSession] = []
        self._position = 0
        self._closed = False
        self._max_retries = seq_manager.config.max_retries
        self._last_prompts = None
        # prompt-prefix routing affinity: same prompt -> same replicas
        self._affinity_seed: Optional[int] = None
        # the phase this session routed as ("prefill" when the first step
        # carries >= config.prefill_tier_tokens tokens, else "decode");
        # decode after the first step, for repairs
        self._phase: Optional[str] = None
        # the handoff tally: adopts, fallbacks to decoding colocated, and
        # adopts that had to replay a tail
        self._handoff_stats = {"adopted": 0, "fallback": 0, "replayed": 0}
        self._last_route_check = time.monotonic()
        # one trace id for the whole session, minted here: every server span
        # (replacements included) opens with it
        self.trace_id: str = new_trace_id()
        # the critical-path profiler: whole-session wall, steps and tokens,
        # and the hops of closed sessions (bounded), so trace_report()
        # accounts for time spent on replaced servers too
        self._wall_s = 0.0
        self._steps = 0
        self._tokens = 0
        self._retired_hops: List[HopTrace] = []
        # the SLO flight recorder (None unless PETALS_TPU_SLO_*_MS is set; a
        # caller may assign a FlightRecorder)
        self.flight = flight_from_env()
        # the fingerprint cross-check of every reply that carries a digest,
        # with digest continuity across repairs and migrations
        self.integrity = IntegrityMonitor(
            trace_id=self.trace_id, on_divergence=self._on_integrity_divergence, flight=self.flight,
        )

    @property
    def position(self) -> int:
        return self._position

    @position.setter
    def position(self, new_position: int) -> None:
        """Roll every server's cache back (the servers are told through
        ``start_from_position`` on the next step)."""
        assert new_position <= self._position, "can only roll back"
        self._position = new_position

    @property
    def num_blocks(self) -> int:
        return len(self.seq_manager.block_uids)

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    async def step(self, hidden, *, prompts=None, hypo_ids=None) -> torch.Tensor:
        """Run ``hidden`` [batch, seq, hidden] through all remote blocks,
        updating every server's cache; returns the last block's output (a CPU
        tensor). ``prompts``: [num_blocks, batch, pre_seq, hidden]."""
        assert not self._closed
        if prompts is not None:
            self._last_prompts = prompts
        inputs = as_tensor(hidden)
        n_input_tokens = inputs.shape[1]
        t_step0 = time.perf_counter()
        if self._position + n_input_tokens > self.max_length:
            raise ValueError(
                f"Maximum length exceeded: prefix {self._position} + current {n_input_tokens}"
                f" exceeds pre-allocated maximum {self.max_length}"
            )
        await self._ensure_route(inputs)

        attempt = 0
        block_idx = 0
        step_id = uuid.uuid4().hex  # petals_tpu servers dedup a relay against a push by it
        while block_idx < self.num_blocks:
            server_idx = self._find_session_index(block_idx)
            session = None
            try:
                if server_idx is None:
                    raise RuntimeError(f"No active session covers block {block_idx}")
                session = self._sessions[server_idx]
                span = session.span
                server_prompts = prompts[span.start : span.end] if prompts is not None else None
                rollback = self._position if session.position > self._position else None
                outputs = await session.step(
                    inputs, prompts=server_prompts, hypo_ids=hypo_ids,
                    start_from_position=rollback, step_id=step_id,
                )
                if outputs.shape != inputs.shape:
                    raise RuntimeError(f"a reply of shape {tuple(outputs.shape)} to a step of {tuple(inputs.shape)}")
                inputs = outputs
                block_idx = span.end
                self.seq_manager.on_request_success(span.peer_id)
                self._maybe_blame_hop(session)
            except Exception as e:
                attempt += 1
                peer = session.span.peer_id if session is not None else None
                self.seq_manager.on_request_failure(peer)
                if self._max_retries is not None and attempt > self._max_retries:
                    raise
                delay = self._backoff(attempt)
                logger.warning(
                    f"Caught exception from block {block_idx} "
                    f"(peer {peer.to_string()[:8] if peer else '?'}), retrying in {delay:.1f}s: {e!r}"
                )
                await asyncio.sleep(delay)
                block_idx = await self._repair_chain(block_idx)

        self._position += n_input_tokens
        self._account_step(time.perf_counter() - t_step0, n_input_tokens)
        if self._phase == "prefill":
            # the prefill is done and decoding begins: hand the KV to a
            # decode-tier replica (a step boundary: the adopt never replays)
            await self._maybe_phase_handoff()
        self._phase = "decode"  # repairs after the first step route decode-ward
        await self._maybe_check_route_upgrade()
        return inputs

    def _spans_support_server_gen(self, spans, sampling: bool = False) -> bool:
        """One span covering every block, announcing ``server_gen`` (or,
        for ``sampling``, ``server_gen_sampling``)."""
        if len(spans) != 1:
            return False
        span = spans[0]
        flag = "server_gen_sampling" if sampling else "server_gen"
        return span.start == 0 and span.end == self.num_blocks and bool(getattr(span.server_info, flag, False))

    def server_gen_available(self, sampling: bool = False) -> bool:
        """Whether the CURRENT route generates on the server; meaningful
        once a route exists."""
        if len(self._sessions) != 1 or self._sessions[0].closed:
            return False
        return self._spans_support_server_gen([s.span for s in self._sessions], sampling=sampling)

    async def generate_remote(self, hidden, n_tokens: int, embed_fn: Callable,
                              sampling: Optional[dict] = None) -> Optional[np.ndarray]:
        """Feed ``hidden`` and have the whole-model server generate
        ``n_tokens`` tokens (greedy, or under a ``gen_sampling`` dict).
        Returns their ids [1, n] (n may be fewer: the server clamps), or
        None when the route cannot generate and nothing was sent. On a
        failure mid-generation the server's cache may have run ahead of
        this session's view: the route is repaired by replaying the
        recorded history onto a fresh chain (the one repair that is always
        consistent) and None returned, so the caller goes on per token."""
        assert not self._closed
        hidden = as_tensor(hidden)
        n_input = hidden.shape[1]
        t_step0 = time.perf_counter()
        if self._position + n_input + n_tokens - 1 > self.max_length:
            return None
        await self._ensure_route(hidden)
        if not self.server_gen_available(sampling=sampling is not None):
            return None
        session = self._sessions[0]
        rollback = self._position if session.position > self._position else None
        try:
            tokens = await session.step_generate(
                hidden, n_tokens, embed_fn, start_from_position=rollback, step_id=uuid.uuid4().hex,
                sampling=sampling,
            )
        except Exception as e:
            logger.warning(f"Server-side generation failed (falling back to the per-token path): {e!r}")
            self.seq_manager.on_request_failure(session.span.peer_id)
            try:
                await self._repair_chain(0)
            except Exception as repair_err:
                # without the replay the servers' caches are empty past this
                # point: continuing would generate garbage, so fail loudly
                raise RuntimeError(
                    "server-side generation failed and the chain could not be repaired; "
                    "the session cannot continue consistently"
                ) from repair_err
            return None
        self.seq_manager.on_request_success(session.span.peer_id)
        self._maybe_blame_hop(session)
        # the server fed what it answered but the last token
        fed = n_input + tokens.shape[1] - 1
        self._position += fed
        self._account_step(time.perf_counter() - t_step0, fed)
        self._phase = "decode"
        await self._maybe_check_route_upgrade()
        return tokens

    def _backoff(self, attempt: int) -> float:
        config = self.seq_manager.config
        return min(config.min_backoff * (2 ** (attempt - 1)), config.max_backoff)

    def _maybe_blame_hop(self, session: _ServerInferenceSession) -> None:
        """A server whose queue wait dominates its hop's wall gets a soft,
        decaying routing penalty (checked every 16 steps)."""
        hop = session.hop
        if not hop.meta_steps or hop.steps % 16 != 0:
            return
        share = hop.queue_share()
        if share > 0.5:
            self.seq_manager.report_congestion(session.span.peer_id, share)

    # ------------------------------------------------- critical-path profiler

    def _account_step(self, wall_s: float, n_tokens: int) -> None:
        """Fold one whole-chain step into the session's totals and hold it
        against the flight recorder's SLOs (the first step is the TTFT)."""
        self._wall_s += wall_s
        self._steps += 1
        self._tokens += max(int(n_tokens), 0)
        if self.flight is None:
            return
        self.flight.observe(
            "ttft" if self._steps == 1 else "token", wall_s, trace_id=self.trace_id,
            # both resolved only when the observation breaches
            waterfall=self.trace_report, journal=self._victim_journal_fetcher(),
        )

    def _on_integrity_divergence(self, peer_id) -> None:
        """A hop's reply diverged from its fused fingerprint: routing gets
        the hard, decaying integrity penalty, so the next route build (and
        any repair) steers off the replica."""
        self.seq_manager.report_integrity(peer_id)

    def trace_report(self) -> dict:
        """The session's per-hop latency waterfall so far: the wall split
        into network / queue / compute / serialize / other, per hop and in
        total, with the dominating (hop, component) critical path."""
        hops = list(self._retired_hops) + [s.hop for s in self._sessions if not s.closed]
        return build_trace_report(
            self.trace_id, [h for h in hops if h.steps > 0], wall_s=self._wall_s, steps=self._steps,
            tokens=self._tokens, retired_hops=len(self._retired_hops),
        )

    def _victim_journal_fetcher(self):
        """A callable for the flight recorder: at a breach, the journal
        excerpt of this trace on the critical-path hop's server, fetched
        from the ``metrics_port`` it announces."""

        def fetch():
            crit = self.trace_report().get("critical_path")
            peer_str = crit["peer"] if crit else None
            victim = next((s for s in self._sessions if not s.closed and s.hop.peer == peer_str), None)
            if victim is None:
                return {"error": "victim hop has no live session", "peer": peer_str}
            port = getattr(victim.span.server_info, "metrics_port", None)
            if not port:
                return {"error": "victim server announces no metrics_port", "peer": peer_str}
            addr = self.seq_manager.addr_of(victim.span.peer_id)
            url = f"http://{addr.host if addr is not None else '127.0.0.1'}:{port}"
            return {"peer": peer_str, "url": url, "events": http_journal_fetcher(url)(self.trace_id)}

        return fetch

    def _journal_export_fallback(self, peer: str, reason: str) -> None:
        """A repair is about to cost a replay (or a second fetch) instead of
        a KV transfer: the journal says why."""
        get_journal().event("export_fallback", trace_id=self.trace_id, peer=peer, reason=reason)

    def usage_report(self) -> dict:
        """The session's resource bill so far, as the servers meter it: each
        hop's ``step_meta["usage"]`` deltas summed per peer and in total,
        closed hops included (a bill after a repair still holds the dead
        server's charges)."""
        hops = list(self._retired_hops) + [s.hop for s in self._sessions if not s.closed]
        per_peer: dict = {}
        total: dict = {}
        for hop in hops:
            if not hop.usage:
                continue
            peer = per_peer.setdefault(str(hop.peer), {})
            for field, amount in hop.usage.items():
                peer[field] = round(peer.get(field, 0.0) + amount, 6)
                total[field] = round(total.get(field, 0.0) + amount, 6)
        # speculative efficiency is re-derived from the summed counters (rates
        # do not sum across replies or peers)
        for usage in (*per_peer.values(), total):
            if usage.get("spec_proposed"):
                usage.update(derive_efficiency(usage))
        return {"trace_id": self.trace_id, "tokens": self._tokens, "total": total, "peers": per_peer}

    def _retire_hops(self, sessions) -> None:
        for s in sessions:
            if s.hop.steps > 0:
                self._retired_hops.append(s.hop)
        if len(self._retired_hops) > MAX_RETIRED_HOPS:
            del self._retired_hops[: len(self._retired_hops) - MAX_RETIRED_HOPS]

    async def _ensure_route(self, hidden: torch.Tensor) -> None:
        if self._sessions:
            return
        if self._affinity_seed is None and self._position == 0 and hidden.shape[1] >= AFFINITY_SEGMENT_TOKENS:
            # hash the first prefill segment, so identical prompts route identically
            seg = hidden[:, :AFFINITY_SEGMENT_TOKENS].contiguous().reshape(-1).view(torch.uint8)
            self._affinity_seed = int.from_bytes(
                hashlib.blake2b(seg.numpy().tobytes(), digest_size=8).digest(), "big"
            )
        if self._phase is None:
            heavy = hidden.shape[1] >= self.seq_manager.config.prefill_tier_tokens
            self._phase = "prefill" if heavy else "decode"
        # opening the first chain is as churn-tolerant as stepping on one: a
        # refused open bans the hop (_enter_server_sessions) and we re-route
        attempt = 0
        while True:
            chain = await self.seq_manager.make_sequence(
                0, self.num_blocks, mode="min_latency",
                cache_tokens_needed=self.batch_size * self.max_length,
                affinity_seed=self._affinity_seed, phase=self._phase,
            )
            try:
                self._sessions = await self._enter_server_sessions(chain)
                return
            except Exception as e:
                attempt += 1
                if self._max_retries is not None and attempt > self._max_retries:
                    raise
                delay = self._backoff(attempt)
                logger.warning(f"Failed to open sessions on the chosen chain, retrying in {delay:.1f}s: {e!r}")
                await asyncio.sleep(delay)

    def _find_session_index(self, block_idx: int) -> Optional[int]:
        for i, session in enumerate(self._sessions):
            if session.span.start == block_idx and not session.closed:
                return i
        return None

    async def _enter_server_sessions(self, chain: List[RemoteSpanInfo],
                                     wire_push: bool = True) -> List[_ServerInferenceSession]:
        """Open one session per span. With ``use_server_to_server`` each
        server is told to push its outputs to the next span's session. A
        repair passes ``wire_push=False``, so that seeding the fresh
        sessions never leaks pushed steps into the surviving downstream
        chain; it links them afterwards through ``pending_push_to``."""
        use_push = wire_push and self.seq_manager.config.use_server_to_server and len(chain) > 1
        session_ids = [uuid.uuid4().hex for _ in chain]
        sessions = []
        try:
            for i, span in enumerate(chain):
                uids = self.seq_manager.block_uids[span.start : span.end]
                push_to = None
                if use_push and i + 1 < len(chain):
                    next_addr = self.seq_manager.addr_of(chain[i + 1].peer_id)
                    if next_addr is not None:
                        push_to = {"addr": next_addr.to_string(), "session_id": session_ids[i + 1]}
                try:
                    session = await _ServerInferenceSession.create(
                        self.seq_manager, span, uids, max_length=self.max_length, batch_size=self.batch_size,
                        session_id=session_ids[i], push_to=push_to, trace_id=self.trace_id,
                    )
                except Exception:
                    # blame the hop that refused, so the retry routes around it
                    self.seq_manager.on_request_failure(span.peer_id)
                    raise
                session.monitor = self.integrity
                # adopt the first hop's echoed id, so the rest of the chain
                # opens with the id the servers registered
                if session.echoed_trace_id and session.echoed_trace_id != self.trace_id:
                    self.trace_id = session.echoed_trace_id
                    self.integrity.trace_id = self.trace_id
                sessions.append(session)
            return sessions
        except Exception:
            for session in sessions:
                await session.close()
            raise

    async def _repair_chain(self, failed_block: int) -> int:
        """Repair only the failed span's range [resume, dead_end), keeping the
        healthy sessions upstream and downstream, and their caches, alive.
        The replacement is seeded by adopting the KV the failed server
        pushed to a replica (its export answers with a redirect, and the
        routing prefers that replica), else by importing the KV it exports,
        else by replaying the recorded history. Returns the block index to
        resume from."""
        dead: Optional[_ServerInferenceSession] = None
        for session in self._sessions:
            if session.span.start <= failed_block < session.span.end:
                dead = session
        if dead is not None:
            resume, dead_end = dead.span.start, dead.span.end
            replay_steps = dead.history_steps()
        else:  # an inconsistent chain (shouldn't happen): rebuild the whole suffix
            resume, dead_end = failed_block, self.num_blocks
            replay_steps = []

        keep_up = [s for s in self._sessions if s.span.end <= resume and not s.closed]
        keep_down = [s for s in self._sessions if s.span.start >= dead_end and not s.closed and s is not dead]
        drop = [s for s in self._sessions if s not in keep_up and s not in keep_down]
        # ask the failed server for the hole's KV BEFORE closing anything (a
        # drained server serves exports after its streams died), or for the
        # replica it pushed the KV to
        exported = redirect = None
        if dead is not None and dead.session_id and self._position > 0:
            got = await self._try_export(dead.span.peer_id, dead.session_id, resume, dead_end)
            if isinstance(got, dict):
                redirect = got["migrated_to"]
            else:
                exported = got
        self._retire_hops(drop)
        for session in drop:
            await session.close()
        prefer_peers = None
        if redirect is not None and redirect.get("peer_id"):
            try:
                prefer_peers = (PeerID.from_string(redirect["peer_id"]),)
            except (ValueError, TypeError):
                prefer_peers = None

        # building and seeding is a chain of RPCs as exposed to the fault as
        # the step that failed: retry the whole attempt with the step loop's
        # backoff; `replay_steps`, `exported` and `redirect` were captured
        # once, so every attempt reseeds from the same sources
        attempt = 0
        while True:
            new_sessions = []
            try:
                await self.seq_manager.update()
                new_chain = await self.seq_manager.make_sequence(
                    resume, dead_end, mode="min_latency",
                    cache_tokens_needed=self.batch_size * self.max_length,
                    affinity_seed=self._affinity_seed, prefer_peers=prefer_peers,
                )
                new_sessions = await self._enter_server_sessions(new_chain, wire_push=False)
                self._sessions = sorted(keep_up + new_sessions + keep_down, key=lambda s: s.span.start)
                # a single-span hole only: a split one would leave the later
                # spans without an input history for a later failover
                seeded = False
                if (redirect is not None and prefer_peers and len(new_sessions) == 1
                        and new_sessions[0].span.peer_id == prefer_peers[0] and dead is not None):
                    try:
                        seeded = await self._seed_by_adopt(
                            new_sessions[0], dead.session_id, int(redirect["position"]), replay_steps,
                        )
                    except Exception as e:
                        logger.warning(f"KV adopt failed, falling back: {e!r}")
                        self._journal_export_fallback(str(redirect.get("peer_id")), repr(e))
                        # the stream's state is unknown after a failed adopt
                        new_sessions = await self._reopen(new_sessions, new_chain, keep_up, keep_down)
                if not seeded and redirect is not None and exported is None and dead is not None:
                    exported = await self._fetch_migrated(redirect, dead.session_id, resume, dead_end)
                if not seeded and exported is not None and len(new_sessions) == 1:
                    try:
                        seeded = await self._seed_by_import(new_sessions[0], exported, replay_steps)
                    except Exception as e:
                        logger.warning(f"KV import failed, replaying history instead: {e!r}")
                        new_sessions = await self._reopen(new_sessions, new_chain, keep_up, keep_down)
                if not seeded:
                    # re-prefill the hole, repeating each recorded step (and its
                    # beam-lane reorder, hypo_ids) in the original order
                    for hidden_step, hypo_step in replay_steps:
                        chunk = hidden_step
                        step_id = uuid.uuid4().hex
                        for session in new_sessions:
                            chunk = await self._replay_step(session, chunk, hypo_step, step_id)
                break
            except Exception as e:
                attempt += 1
                for session in new_sessions:
                    try:
                        await session.close()
                    except Exception:
                        pass  # best effort: the session is abandoned either way
                    self.seq_manager.on_request_failure(session.span.peer_id)
                self._sessions = sorted(keep_up + keep_down, key=lambda s: s.span.start)
                if self._max_retries is not None and attempt > self._max_retries:
                    raise
                delay = self._backoff(attempt)
                logger.warning(
                    f"Chain repair for blocks [{resume}, {dead_end}) failed (attempt {attempt}), "
                    f"retrying in {delay:.1f}s: {e!r}"
                )
                await asyncio.sleep(delay)
        self._wire_repair_pushes(keep_up, new_sessions, keep_down, dead_end)
        return resume

    async def _reopen(self, new_sessions, new_chain, keep_up, keep_down) -> List[_ServerInferenceSession]:
        """Close the fresh sessions of a repair (a failed adopt or import
        leaves their streams in an unknown state) and open them again."""
        for session in new_sessions:
            await session.close()
        new_sessions = await self._enter_server_sessions(new_chain, wire_push=False)
        self._sessions = sorted(keep_up + new_sessions + keep_down, key=lambda s: s.span.start)
        return new_sessions

    async def _replay_step(self, session, chunk, hypo_step, step_id):
        span = session.span
        server_prompts = self._last_prompts[span.start : span.end] if self._last_prompts is not None else None
        return await session.step(chunk, prompts=server_prompts, hypo_ids=hypo_step, step_id=step_id)

    def _export_compression(self) -> str:
        """The session's wire codec for a KV export, but bfloat16 for qint8:
        blockwise int8 of the KV would degrade every later token, where the
        replay it stands in for is exact."""
        comp = self.seq_manager.config.compression
        return CompressionType.BFLOAT16.value if comp == CompressionType.QINT8.value else comp

    async def _export_from(self, stub, session_id: str, start: int, end: int):
        """One ``ptu.session_export`` call: (k, v, position), a
        ``{"migrated_to": ...}`` redirect, or None for another batch size."""
        reply = await asyncio.wait_for(
            stub.call("ptu.session_export", {"session_id": session_id, "start": start, "end": end,
                                             "compression": self._export_compression()}),
            timeout=self.seq_manager.config.kv_export_timeout,
        )
        fwd = reply.get("migrated_to")
        if isinstance(fwd, dict) and fwd.get("addr"):
            return {"migrated_to": fwd}
        if int(reply.get("batch_size", -1)) != self.batch_size:
            return None
        k = deserialize_array(reply["tensors"]["k"])
        v = deserialize_array(reply["tensors"]["v"])
        return k, v, int(reply["position"])

    async def _try_export(self, peer_id, session_id: str, start: int, end: int):
        """The failed span's KV from its (maybe draining) server: (k, v,
        position), a ``{"migrated_to": ...}`` redirect when it pushed the KV
        to a peer, or None, and the caller replays. A quick liveness probe
        first, so that a dead peer costs seconds and not the transfer's
        ``kv_export_timeout``."""
        try:
            stub = await asyncio.wait_for(self.seq_manager.get_stub(peer_id), timeout=5)
            await asyncio.wait_for(stub.call("ptu.info", {}), timeout=3)
            got = await self._export_from(stub, session_id, start, end)
            if isinstance(got, dict):
                logger.info(f"Session KV moved from {peer_id.to_string()[:8]} to "
                            f"{str(got['migrated_to'].get('peer_id'))[:8]}: retargeting")
            return got
        except Exception as e:
            logger.info(f"KV export unavailable from {peer_id.to_string()[:8]}: {e!r}")
            self._journal_export_fallback(peer_id.to_string(), repr(e))
            return None

    async def _fetch_migrated(self, fwd: dict, session_id: str, start: int, end: int):
        """The failed server pushed the KV to a peer, but the new chain did
        not land there (or the adopt failed): pull the migrated copy from
        its new home over the client's link. One forwarding hop only."""
        try:
            stub = await asyncio.wait_for(self.seq_manager.pool.get_addr(PeerAddr.from_string(fwd["addr"])), timeout=5)
            got = await self._export_from(stub, session_id, start, end)
            return None if isinstance(got, dict) else got
        except Exception as e:
            logger.info(f"Migrated KV unavailable from {fwd.get('addr')}: {e!r}")
            self._journal_export_fallback(str(fwd.get("peer_id")), repr(e))
            return None

    def _cut_at_step(self, export_pos: int, replay_steps) -> tuple:
        """(tokens, steps) of the longest prefix of the history whose length
        fits in ``export_pos`` and the session's position: a seed cuts at a
        step boundary, so each step's hypo_ids reorder stays whole. (0, 0)
        when the export is AHEAD of the client (a step's reply was lost: a
        hypo_ids reorder in it would leave the cache permuted against the
        history; the replay is exact)."""
        if export_pos > self._position:
            return 0, 0
        cut = n_prefix = 0
        for hidden_step, _ in replay_steps:
            if cut + hidden_step.shape[1] > export_pos:
                break
            cut += hidden_step.shape[1]
            n_prefix += 1
        return cut, n_prefix

    async def _seed_by_import(self, session, exported, replay_steps) -> bool:
        """Import exported KV up to a history step boundary, then replay the
        recorded steps past it (a parked export can be a little stale)."""
        k, v, export_pos = exported
        cut, n_prefix = self._cut_at_step(export_pos, replay_steps)
        if cut <= 0:
            return False
        await session.import_kv(k[:, :, :cut], v[:, :, :cut], cut)
        session.history = [tuple(step) for step in replay_steps[:n_prefix]]
        for hidden_step, hypo_step in replay_steps[n_prefix:]:
            await self._replay_step(session, hidden_step, hypo_step, uuid.uuid4().hex)
        logger.info(f"Imported {cut} cached tokens into {session.span.peer_id.to_string()[:8]} "
                    f"(+{len(replay_steps) - n_prefix} replayed steps)")
        return True

    async def _seed_by_adopt(self, session, source_session_id: str, export_pos: int, replay_steps) -> bool:
        """Adopt migrated KV already on the replacement server, up to a
        history step boundary, then replay the steps past it; the KV never
        crosses the client's link."""
        cut, n_prefix = self._cut_at_step(export_pos, replay_steps)
        if cut <= 0:
            return False
        await session.adopt_kv(source_session_id, cut)
        session.history = [tuple(step) for step in replay_steps[:n_prefix]]
        for hidden_step, hypo_step in replay_steps[n_prefix:]:
            await self._replay_step(session, hidden_step, hypo_step, uuid.uuid4().hex)
        logger.info(f"Adopted {cut} migrated tokens on {session.span.peer_id.to_string()[:8]} "
                    f"(+{len(replay_steps) - n_prefix} replayed steps)")
        return True

    async def _maybe_check_route_upgrade(self) -> None:
        """The periodic better-chain check, after a step or a generated
        chunk alike (a session served by generation RPCs alone must still
        move onto a faster server that joins)."""
        period = self.seq_manager.config.route_upgrade_period
        if period and time.monotonic() - self._last_route_check >= period:
            self._last_route_check = time.monotonic()
            try:
                await self._maybe_upgrade_route()
            except Exception as e:
                logger.warning(f"Route upgrade check failed (continuing as is): {e!r}")

    async def _maybe_upgrade_route(self) -> bool:
        """Move the session onto a clearly better chain (a fast server
        joined, congestion cleared) by live ``ptu.session_export``, with no
        prefill recomputed. The current chain serves until every
        replacement is seeded, and any failure abandons the attempt."""
        current = [s for s in self._sessions if not s.closed]
        if not current or self._position == 0:
            return False
        await self.seq_manager.update()
        tokens_needed = self.batch_size * self.max_length
        candidate = await self.seq_manager.make_sequence(
            0, self.num_blocks, mode="min_latency", cache_tokens_needed=tokens_needed,
            affinity_seed=self._affinity_seed,
        )
        if [(c.peer_id, c.start, c.end) for c in candidate] == [(s.span.peer_id, s.span.start, s.span.end)
                                                                  for s in current]:
            return False
        cur_cost = self.seq_manager.estimate_chain_latency([s.span for s in current], cache_tokens_needed=tokens_needed)
        new_cost = self.seq_manager.estimate_chain_latency(candidate, cache_tokens_needed=tokens_needed)
        if new_cost > self.seq_manager.config.route_upgrade_threshold * cur_cost:
            return False
        # the latency model is blind to server-side generation, which
        # amortizes the round trip over whole chunks: never trade it away
        if self.server_gen_available() and not self._spans_support_server_gen(candidate):
            return False
        # each new span's input history must exist on the client: its start
        # must be a current span's start
        starts = {s.span.start for s in current}
        if any(c.start not in starts for c in candidate):
            return False
        logger.info(f"Upgrading route (estimated {cur_cost * 1e3:.0f} -> {new_cost * 1e3:.0f} ms/token)")
        return await self._migrate_to(candidate, current)

    async def _migrate_to(self, chain, current) -> bool:
        """Open sessions for ``chain``, seeding each NEW span by exports of
        the live current sessions (sliced by block, joined across their
        boundaries); a current session that matches a span is kept."""
        by_start = {s.span.start: s for s in current}
        new_sessions: List[_ServerInferenceSession] = []
        created: List[_ServerInferenceSession] = []
        try:
            for span in chain:
                existing = by_start.get(span.start)
                if existing is not None and existing.span.peer_id == span.peer_id and existing.span.end == span.end:
                    new_sessions.append(existing)
                    continue
                # the (cheap) open before the (expensive) exports: a candidate
                # that refuses the open must not cost a KV transfer
                uids = self.seq_manager.block_uids[span.start : span.end]
                session = await _ServerInferenceSession.create(
                    self.seq_manager, span, uids, max_length=self.max_length, batch_size=self.batch_size,
                    session_id=uuid.uuid4().hex, trace_id=self.trace_id,
                )
                session.monitor = self.integrity
                created.append(session)
                pieces, export_pos = [], self._position
                for cur in sorted(current, key=lambda s: s.span.start):
                    lo, hi = max(cur.span.start, span.start), min(cur.span.end, span.end)
                    if lo >= hi:
                        continue
                    got = await self._try_export(cur.span.peer_id, cur.session_id, lo, hi)
                    if got is None or isinstance(got, dict):
                        # a redirect: the live session moved meanwhile, and the
                        # repair path handles it
                        raise RuntimeError(f"export of blocks [{lo}, {hi}) unavailable")
                    pieces.append(got)
                    export_pos = min(export_pos, got[2])
                k_all = torch.cat([k[:, :, :export_pos] for k, _, _ in pieces], dim=0)
                v_all = torch.cat([v[:, :, :export_pos] for _, v, _ in pieces], dim=0)
                if k_all.shape[0] != span.end - span.start:
                    raise RuntimeError(f"exported {k_all.shape[0]} blocks for span [{span.start}, {span.end})")
                if not await self._seed_by_import(session, (k_all, v_all, export_pos),
                                                  by_start[span.start].history_steps()):
                    raise RuntimeError("the exported cache is too stale (or ahead of us) to seed from")
                new_sessions.append(session)
        except Exception as e:
            logger.warning(f"Route upgrade abandoned (staying on the current chain): {e!r}")
            for session in created:
                await session.close()
            # back off: the same doomed attempt must not repeat every period
            self._last_route_check = time.monotonic() + 4 * self.seq_manager.config.route_upgrade_period
            return False
        replaced = [s for s in current if s not in new_sessions]
        self._retire_hops(replaced)
        for session in replaced:
            await session.close()
        self._sessions = new_sessions
        self._wire_push_chain(new_sessions)
        return True

    async def _maybe_phase_handoff(self) -> None:
        """The prefill-to-decode handoff: a session that just prefilled on a
        prefill-tier replica routes its decoding onto decode-tier replicas,
        the KV moving server to server (``ptu.session_handoff`` on the
        source, ``kv_adopt`` at the destination). The cut is the step
        boundary, so the adopt never replays and no KV crosses the client's
        link. Any failure decodes where the session prefilled: the current
        chain keeps serving."""
        cfg = self.seq_manager.config
        self._phase = "decode"  # later routing (repairs) scores decode-ward
        if not cfg.disagg_handoff or self._position == 0:
            return
        current = [s for s in self._sessions if not s.closed]
        if not current or not any(getattr(s.span.server_info, "phase_tier", None) == "prefill" for s in current):
            return  # nothing prefill-tiered to hand off from

        def fallback(reason: str) -> None:
            self._handoff_stats["fallback"] += 1
            get_journal().event("handoff_fallback", trace_id=self.trace_id, reason=reason)
            logger.info(f"Phase handoff skipped, decoding colocated: {reason}")

        try:
            candidate = await self.seq_manager.make_sequence(
                0, self.num_blocks, mode="min_latency", cache_tokens_needed=self.batch_size * self.max_length,
                affinity_seed=self._affinity_seed, phase="decode",
            )
        except Exception as e:
            fallback(f"decode routing failed: {e!r}")
            return
        # whole spans move: the decode chain must cut where the prefill one does
        if [(c.start, c.end) for c in candidate] != [(s.span.start, s.span.end) for s in current]:
            fallback("decode chain spans misaligned with prefill chain")
            return
        moves = [(old, span) for old, span in zip(current, candidate) if span.peer_id != old.span.peer_id]
        if not moves:
            fallback("no better decode-tier replica than the prefill chain")
            return
        if not all(getattr(span.server_info, "phase_tier", None) == "decode" for _, span in moves):
            fallback("best decode chain is not decode-tiered")  # moving to a generalist buys nothing
            return
        replaced: List[_ServerInferenceSession] = []
        created: List[_ServerInferenceSession] = []
        try:
            for old, span in moves:
                addr = self.seq_manager.addr_of(span.peer_id)
                if addr is None:
                    raise RuntimeError(f"no address for decode replica {span.peer_id.to_string()[:8]}")
                # the source pushes the KV as of this step boundary to the replica
                stub = await self.seq_manager.get_stub(old.span.peer_id)
                reply = await asyncio.wait_for(
                    stub.call("ptu.session_handoff", {
                        "session_id": old.session_id, "peer_id": span.peer_id.to_string(),
                        "addr": addr.to_string(), "deadline_s": cfg.handoff_timeout,
                    }),
                    timeout=cfg.handoff_timeout + 5.0,
                )
                if not reply.get("ok"):
                    raise RuntimeError(f"source refused handoff: {reply}")
                # a fresh session there adopts it in place
                uids = self.seq_manager.block_uids[span.start : span.end]
                session = await _ServerInferenceSession.create(
                    self.seq_manager, span, uids, max_length=self.max_length, batch_size=self.batch_size,
                    session_id=uuid.uuid4().hex, trace_id=self.trace_id,
                )
                session.monitor = self.integrity
                created.append(session)
                export_pos = int(reply["position"])
                if export_pos < self._position:
                    self._handoff_stats["replayed"] += 1  # the cut missed the boundary: the adopt replays
                if not await self._seed_by_adopt(session, old.session_id, export_pos, old.history_steps()):
                    raise RuntimeError("pushed KV too stale to adopt")
                replaced.append(old)
        except Exception as e:
            for session in created:
                try:
                    await session.close()
                except Exception:
                    pass  # best effort: the prefill chain is still live
            fallback(repr(e))
            return
        by_old = dict(zip(replaced, created))
        self._sessions = sorted([by_old.get(s, s) for s in current], key=lambda s: s.span.start)
        self._retire_hops(replaced)
        for old in replaced:
            try:
                await old.close()
            except Exception:
                pass  # the source may already be tearing the lane down
        self._wire_push_chain(self._sessions)
        self._handoff_stats["adopted"] += len(replaced)
        get_journal().event("handoff_complete", trace_id=self.trace_id, moved=len(replaced), position=self._position)

    def _push_target(self, session) -> Optional[dict]:
        if session is None or not session.session_id:
            return None
        addr = self.seq_manager.addr_of(session.span.peer_id)
        return None if addr is None else {"addr": addr.to_string(), "session_id": session.session_id}

    def _wire_push_chain(self, sessions: List[_ServerInferenceSession]) -> None:
        """Point each session's pushes at the next one (sent with its next step)."""
        if not self.seq_manager.config.use_server_to_server:
            return
        for i, session in enumerate(sessions):
            nxt = sessions[i + 1] if i + 1 < len(sessions) else None
            session.pending_push_to = self._push_target(nxt) or False

    def _wire_repair_pushes(self, keep_up, new_sessions, keep_down, dead_end: int) -> None:
        """Re-link the push chain around a repaired hole (the surviving
        upstream server still pushes to a dead session id)."""
        if not self.seq_manager.config.use_server_to_server:
            return
        downstream = keep_down[0] if keep_down and keep_down[0].span.start == dead_end else None
        chain = list(new_sessions) + [downstream]
        for i, session in enumerate(new_sessions):
            session.pending_push_to = self._push_target(chain[i + 1]) or False
        if keep_up:
            keep_up[-1].pending_push_to = self._push_target(new_sessions[0] if new_sessions else None) or False

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._retire_hops(self._sessions)
            for session in self._sessions:
                await session.close()
            self._sessions = []
