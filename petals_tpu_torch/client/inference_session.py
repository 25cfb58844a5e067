"""Client-side autoregressive inference over a chain of servers
(petals_tpu/client/inference_session.py).

- ``_ServerInferenceSession`` drives one server's bidirectional inference
  stream: open with (uids, max_length), then step (hidden, prompts,
  hypo_ids, start_from_position). It records the ``history`` of inputs it
  sent, so a replacement server's KV cache can be rebuilt after a failure.
- ``InferenceSession`` chains per-span sessions across the whole model. On
  a step failure it bans the peer, rebuilds the failed span's range only,
  keeping the healthy sessions and their caches, and replays the recorded
  history through the new span (``_replay_step``), so every replacement
  server re-prefills its cache and generation continues unnoticed.
- ``generate_remote``: over a route of one span covering the whole model
  whose server announces ``server_gen`` (``server_gen_sampling`` for a
  ``sampling`` dict), the server generates a chunk of tokens in one step
  (``step_generate``); the session records the embeddings of the tokens the
  server fed, so a replay rebuilds the same cache. A failure mid-chunk
  tears the route down and repairs it by replay, and the caller goes on
  per token.

Hidden states are CPU tensors on the wire side (``rpc/serialization.py``).

Left out, each with the slice that takes it (ROADMAP.md): ``import_kv``,
``adopt_kv``, ``_try_export``, ``_seed_by_import`` / ``_seed_by_adopt``,
``_maybe_upgrade_route`` / ``_migrate_to``, ``_maybe_phase_handoff`` and
the server-to-server push wiring (``_wire_push_chain``,
``_wire_repair_pushes``) and the route-upgrade check after a generated
chunk (``_maybe_check_route_upgrade``): A9; without push wiring the client
relays every hop, and a repair always replays. ``IntegrityMonitor``, ``HopTrace``'s
waterfall, ``trace_report`` and the flight recorder: A11; a hop keeps only
what routing blame and ``usage_report`` read (``_Hop``).
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
from petals_tpu_torch.data_structures import CHAIN_DELIMITER, RemoteSpanInfo
from petals_tpu_torch.rpc.client import StreamCall
from petals_tpu_torch.rpc.serialization import CompressionType, as_tensor, deserialize_array, serialize_array
from petals_tpu_torch.server.handler import new_trace_id

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
MAX_RETIRED_HOPS = 32  # hops of closed sessions kept for usage_report


class _Hop:
    """One server span's client-side account: steps, the client's wall, the
    server-reported queue time (routing blame reads its share) and the
    server-billed usage deltas riding ``step_meta`` (``usage_report`` sums
    them). The rest of petals_tpu's HopTrace waits for A11."""

    def __init__(self, peer: str):
        self.peer = peer
        self.steps = 0
        self.meta_steps = 0
        self.wall_s = 0.0
        self.queue_s = 0.0
        self.usage: dict = {}

    def record(self, wall_s: float, meta: Optional[dict]) -> None:
        self.steps += 1
        self.wall_s += max(float(wall_s), 0.0)
        if not meta:
            return
        self.meta_steps += 1
        self.queue_s += float(meta.get("queue_s") or 0.0)
        usage = meta.get("usage")
        if isinstance(usage, dict):
            for field, amount in usage.items():
                if field in ("acceptance_rate", "tokens_per_compute_second"):
                    continue  # rates don't sum
                try:
                    self.usage[field] = self.usage.get(field, 0) + float(amount)
                except (TypeError, ValueError):
                    continue  # a malformed server delta must not kill the step

    def queue_share(self) -> float:
        return self.queue_s / self.wall_s if self.wall_s > 0 else 0.0


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
        self.echoed_trace_id: Optional[str] = None
        self.hop = _Hop(span.peer_id.to_string())

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
            self.hop.record(open_wall_s, {"queue_s": open_wait_s})
            share = self.hop.queue_share()
            if open_wait_s >= OPEN_WAIT_BLAME_S and share > 0.5:
                seq_manager.report_congestion(span.peer_id, share)
                # the cached swarm view is stale: capacity announced since the
                # last update becomes routable now
                seq_manager.request_refresh()
        return self

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
        self.hop.record(time.perf_counter() - t_rpc, reply.get("step_meta"))
        out = deserialize_array(reply["tensors"]["hidden"])
        self.position = reply["position"]
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
        self.hop.record(time.perf_counter() - t_rpc, reply.get("step_meta"))
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
        # one trace id for the whole session, minted here: every server span
        # (replacements included) opens with it
        self.trace_id: str = new_trace_id()
        self._tokens = 0
        self._retired_hops: List[_Hop] = []

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
        self._tokens += n_input_tokens
        self._phase = "decode"  # repairs after the first step route decode-ward
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
        self._tokens += fed
        self._phase = "decode"
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

    def usage_report(self) -> dict:
        """The session's resource bill so far, as the servers meter it: each
        hop's ``step_meta["usage"]`` deltas summed per peer and in total,
        closed hops included (a bill after a repair still holds the dead
        server's charges). A port server bills nothing yet (A8)."""
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

    async def _enter_server_sessions(self, chain: List[RemoteSpanInfo]) -> List[_ServerInferenceSession]:
        """Open one session per span (the server-to-server push petals_tpu
        wires here waits for A9: the client relays every hop)."""
        sessions = []
        try:
            for span in chain:
                uids = self.seq_manager.block_uids[span.start : span.end]
                try:
                    session = await _ServerInferenceSession.create(
                        self.seq_manager, span, uids, max_length=self.max_length,
                        batch_size=self.batch_size, session_id=uuid.uuid4().hex, trace_id=self.trace_id,
                    )
                except Exception:
                    # blame the hop that refused, so the retry routes around it
                    self.seq_manager.on_request_failure(span.peer_id)
                    raise
                # adopt the first hop's echoed id, so the rest of the chain
                # opens with the id the servers registered
                if session.echoed_trace_id and session.echoed_trace_id != self.trace_id:
                    self.trace_id = session.echoed_trace_id
                sessions.append(session)
            return sessions
        except Exception:
            for session in sessions:
                await session.close()
            raise

    async def _repair_chain(self, failed_block: int) -> int:
        """Repair only the failed span's range [resume, dead_end), keeping the
        healthy sessions upstream and downstream, and their caches, alive.
        The replacement is seeded by replaying the recorded input history
        (KV export and migration wait for A9). Returns the block index to
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
        self._retire_hops(drop)
        for session in drop:
            await session.close()

        # building and seeding is a chain of RPCs as exposed to the fault as
        # the step that failed: retry the whole attempt with the step loop's
        # backoff; `replay_steps` was captured once, so every attempt reseeds
        # from the full history
        attempt = 0
        while True:
            new_sessions = []
            try:
                await self.seq_manager.update()
                new_chain = await self.seq_manager.make_sequence(
                    resume, dead_end, mode="min_latency",
                    cache_tokens_needed=self.batch_size * self.max_length,
                    affinity_seed=self._affinity_seed,
                )
                new_sessions = await self._enter_server_sessions(new_chain)
                self._sessions = sorted(keep_up + new_sessions + keep_down, key=lambda s: s.span.start)
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
        return resume

    async def _replay_step(self, session, chunk, hypo_step, step_id):
        span = session.span
        server_prompts = self._last_prompts[span.start : span.end] if self._last_prompts is not None else None
        return await session.step(chunk, prompts=server_prompts, hypo_ids=hypo_step, step_id=step_id)

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._retire_hops(self._sessions)
            for session in self._sessions:
                await session.close()
            self._sessions = []
