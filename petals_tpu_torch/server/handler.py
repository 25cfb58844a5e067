"""RPC surface of a port server: ``ptu.inference`` sessions, the stateless
``ptu.forward`` and its ``ptu.backward``, the integrity probe ``ptu.probe``
and ``ptu.info`` (the subset of petals_tpu/server/handler.py this port
serves). The frames and tensor encodings are those of a petals_tpu server,
so petals_tpu clients drive it unchanged.

The stateless forward (petals_tpu/server/handler.py:1253-1281): ``{uids,
tensors: {hidden, prompts?}, compression?}`` runs the span's ``forward``
(one step program per (batch, seq, pre_seq)) on the task queue at
``PRIORITY_TRAINING`` with size batch * seq, under ``request_timeout``, and
replies ``{tensors: {hidden}}`` in the reply codec. A step that timed out
still finishes on the compute thread (a running step cannot be cancelled)
and its result is dropped.

The backward (petals_tpu/server/handler.py:1283-1320): ``{uids, tensors:
{hidden, grad_out, prompts?}, compression?, active_adapter?}`` runs the
span's ``backward`` (the blocks recomputed under autograd) on the task
queue at ``PRIORITY_TRAINING`` under ``request_timeout`` and replies
``{tensors: {grad_hidden, grad_prompts?}}`` in the reply codec, with
petals_tpu's shape checks and texts.

LoRA adapters (utils/peft.py): ``ptu.forward``, ``ptu.backward`` and the
inference open take ``active_adapter``, the name of one of the adapters
the server hosts; an unknown name is refused up front with petals_tpu's
KeyError text. An adapter session never takes a lane of the shared pool
(its graphs would address the pool's weights without the adapter's) and
never reads or writes the prefix cache (its rows are the adapter's own):
it gets a private cache, and its steps and generated tokens apply the
adapter.

The integrity probe (:1362-1404): a caller-seeded golden input
(``RandomState(seed & 0x7FFFFFFF)``, scaled by 0.02, 1 to 16 tokens) runs
through the span's forward, and the reply carries the fingerprint of its
last row (ops/fingerprint.py) with the seed, the token count and the span.
Its output passes the chaos plane's ``integrity.corrupt`` site, as a
session's replies do (chaos/), so an injected corruption shows in the probe.

Telemetry (telemetry/): every site where petals_tpu's handler records,
this one records, into the port's registry and journal: TTFT on a
session's first content reply, the pooled decode's token latency, reply
serialization, the migration and handoff counters and journal events; the
``rpc_forward``, ``rpc_probe`` and ``inference_step`` spans feed
``ptu.info``'s ``tracing``, beside ``telemetry`` (``telemetry_digest``)
and ``compile_stats`` (the step-program observatory). With fingerprints
enabled (``PETALS_TPU_FINGERPRINT``), each pooled decode or paged prefill
reply carries the step program's fused digest of its last row in
``step_meta["fp"]``.

A session of batch size 1 over the whole span, with no adapter and a
``max_length`` within the lane length, borrows a LANE of the batcher's shared
pool and decodes coalesced with its neighbours; when no lane frees in time it
falls back to a private cache. Every other session (batch > 1, a sub-span, a
longer ``max_length``) gets a PRIVATE dense cache [n_blocks, batch,
max_length, hkv, d], budgeted through the memory cache, and steps through the
task queue. Each reply's ``step_meta.variant`` says which path a step took:
``decode`` / ``prefill`` (the batcher's coalesced steps), ``dense_prefill``
(a dense lane's chunked prefill), ``exclusive`` (deep prompts or hypo_ids on
a pooled lane), ``private``; a step that also generated adds ``+gen``
when its lane's generation steps ran in the batcher.

Server-side generation (petals_tpu/server/handler.py:1966-2077): a step
with ``gen_tokens`` (clamped to a power of two up to 32) and an optional
``gen_sampling`` dict runs its hidden states as any step, then generates
that many tokens from the last output row, and replies with the token ids
instead of hidden states. Only a server holding the client's leaves
(``server_gen_params``) answers it, and only for a whole-model session of
batch 1 with no deep prompts and no hypo_ids: a pooled session's tokens come
from the batcher's generation steps (``generate_lane``), a private
session's from ``backend.generate_tokens`` on the task queue.

The prefix cache (server/prefix_cache.py; petals_tpu/server/handler.py
:1631-1970), on by default as in petals_tpu: a fresh batch-1 prefill of at
least ``SEGMENT_TOKENS`` tokens with no deep prompts, hypo_ids or adapter
is hashed, off the event loop, into segment keys over its wire bytes,
salted by the span (and, under ``prefix_share_scope="peer"``, by the
client's proven peer id; a client without one is not cached). Its longest
cached path seeds the session's KV without recomputing it, from the first
tier that holds all of it: a paged lane adopts the pinned pages (zero
bytes copied); else the device tier's copies, else the host tier's rows,
are written into the lane or the private cache in place (after a host-tier
hit, hot nodes move up to the device tier off the reply path). Only the
tail runs, at position ``hit_len``; a prefill that is cached whole runs
nothing on the device (variant ``cached``). The cached outputs come ahead
of the tail's. After the reply a task stores the new segments (pinning a
paged lane's pages; copying a dense lane's or a private cache's rows to
the device tier, and every segment's rows to the host); the session awaits
it before its next step, so the stored rows are what the content hash
names. ``ptu.info`` carries the cache's ``summary()`` as ``prefix_cache``.

The session-open ack echoes the client's ``trace_id``, normalized, or one
minted here, as petals_tpu's does. ``ptu.info`` reports the fields of the
ServerInfo the server announces (``server_info_fn``) beside the handler's
own, and the pool's occupancy with the scheduler's summary (``pool``). A
client id proven by the RPC handshake is ``ctx.remote_peer_id``.

The scheduler and the ledger (petals_tpu/server/handler.py:1448-1488,
2111-2118): a session bills to the client's proven peer id, else to the
open message's self-declared ``peer_hint``, else anonymously; that peer and
the open message's ``priority`` go to ``acquire_lane``, and the prefix
cache bills the segments it stores to it. Each pooled reply's step_meta
carries the load hint (``busy_lanes``, ``lane_waiters``) and the session's
``usage`` since its last reply. A store after a prefill reads a lane that
was preempted meanwhile from its swap entry (``snapshot_from_swap``)
rather than swap it back in.

Sessions move between servers (petals_tpu/server/handler.py:267-1160,
2146-2271). An open message with a ``session_id`` registers the session, so
that ``ptu.session_export`` can hand its KV (sliced to its position and to
the asked blocks, dense on the wire: a quantized pool's rows decoded) to a
client seeding a replacement by a ``kv_import`` first step. A draining
server parks every live session's KV in host memory (``park_sessions``)
and pushes it to a replica over ``ptu.session_migrate``
(``migrate_parked_to``); the replica holds it under a byte budget and a TTL
until the client opens there with a ``kv_adopt`` first step, and the source
answers later exports with a ``migrated_to`` redirect. A prefill-tier
server pushes a LIVE session the same way on ``ptu.session_handoff``, and
keeps it. Every seed writes the lane's pages or the private cache IN PLACE
(``_seed_kv``), so the step programs that captured those buffers stay valid.
A ``push_to`` (from the open message, or retargeted by a step) makes each
step's reply also go to the next server's session (``ptu.push``), which
serves whichever copy of a ``step_id`` comes first and skips the other; a
step with deep prompts is not pushed. A draining server refuses new
sessions and every further step.

With no batcher (``--no_batching``, petals_tpu/server/handler.py:155)
every session gets a private cache, and ``ptu.info`` has no pool fields. A
span move hands the handler a new backend and pool (``swap_backend``);
sessions opened before it keep the backend they opened on. The chaos plane
(chaos/) fires at the step boundary (``handler.step``, before the step is
queued), in a migration or handoff push (inside its deadline), and on the
host copy of a probe's or a session's reply (``integrity.corrupt``,
matched by this server's peer id).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from petals_tpu_torch import chaos
from petals_tpu_torch.data_structures import CHAIN_DELIMITER, parse_session_priority, parse_uid
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.ops.paged_attention import KV_QUANT_KINDS, dequantize_kv_np, quantize_kv_rows_np
from petals_tpu_torch.rpc.pool import ConnectionPool
from petals_tpu_torch.rpc.protocol import validate_gen_sampling
from petals_tpu_torch.rpc.serialization import CompressionType, deserialize_array, is_dummy, serialize_array
from petals_tpu_torch.rpc.server import RpcContext, RpcServer
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.memory_cache import AllocationFailed
from petals_tpu_torch.server.prefix_cache import SEGMENT_TOKENS, PrefixCache, segment_keys
from petals_tpu_torch.ops import fingerprint as fp_ops
from petals_tpu_torch.server.task_queue import PRIORITY_INFERENCE, PRIORITY_TRAINING
from petals_tpu_torch.telemetry import instruments as tm
from petals_tpu_torch.telemetry.exposition import telemetry_digest
from petals_tpu_torch.telemetry.flight import flight_from_env
from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.observatory import get_observatory
from petals_tpu_torch.telemetry.trace import new_trace_id, normalize_trace_id, reset_trace_id, set_trace_id
from petals_tpu_torch.utils.asyncio_utils import log_exception_callback
from petals_tpu_torch.utils.tracing import device_annotation, get_tracer
from petals_tpu_torch.utils.version import incompatibility_error, is_compatible

logger = logging.getLogger(__name__)

MAX_GEN_TOKENS = 32  # the longest chunk a generating step answers
# a speculating stream's evidence in its reply's step_meta
SPEC_META_KEYS = ("spec_proposed", "spec_accepted", "acceptance_rate")



class TransformerHandler:
    def __init__(
        self,
        backend,
        batcher,
        *,
        dht_prefix: str,
        memory_cache=None,  # with no batcher: the private caches' budget
        queue=None,  # with no batcher: the compute thread's queue
        ledger=None,  # with no batcher: the resource ledger the prefix cache bills
        compression: CompressionType = CompressionType.NONE,
        inference_max_length: Optional[int] = None,
        session_timeout: float = 30 * 60,
        step_timeout: float = 5 * 60,
        request_timeout: float = 3 * 60,  # a stateless forward or probe
        server_info_fn: Optional[Callable[[], dict]] = None,  # the announced ServerInfo's fields
        server_gen_params: Optional[dict] = None,  # the client's leaves: server-side generation
        prefix_cache_bytes: int = 256 * 2**20,  # host tier of the prefix cache; 0 disables it
        prefix_share_scope: str = "swarm",  # "swarm" shares across clients; "peer" salts per client
        prefix_device_bytes: int = 256 * 2**20,  # its HBM tier; 0 disables
        prefix_cache_policy: str = "radix",  # "radix" tree | "lru" flat baseline
        identity=None,  # proves this server's peer id to the peers it pushes to
    ):
        if prefix_share_scope not in ("swarm", "peer"):
            raise ValueError(f"prefix_share_scope must be 'swarm' or 'peer', got {prefix_share_scope!r}")
        self.backend = backend
        self.server_gen_params = server_gen_params
        self.server_info_fn = server_info_fn
        # None serves every session from a private cache (--no_batching);
        # else private sessions share the batcher's budget and compute thread
        self.batcher = batcher
        self.memory_cache = batcher.memory_cache if batcher is not None else memory_cache
        self.queue = batcher.queue if batcher is not None else queue
        self.ledger = batcher.ledger if batcher is not None else ledger
        self._sub_backends = {}
        self.dht_prefix = dht_prefix
        self.compression = CompressionType(compression)
        self.inference_max_length = inference_max_length
        self.session_timeout = session_timeout
        self.step_timeout = step_timeout
        self.request_timeout = request_timeout
        self.prefix_share_scope = prefix_share_scope
        self.prefix_cache = None
        if prefix_cache_bytes > 0:
            # the swapped tier shares the batcher's swap budget (one budget
            # with session preemption), and eviction ranks tenants by the
            # ledger's dominant share, which also bills their residency
            # (a server with no batcher has no swap pool: demotion evicts)
            self.prefix_cache = PrefixCache(
                prefix_cache_bytes, device_max_bytes=prefix_device_bytes, policy=prefix_cache_policy,
                device=backend.device, swap_pool=batcher.swap_pool if batcher is not None else None,
                usage_fn=self.ledger.peer_dominant_share, ledger=self.ledger,
            )
            # a pinned page run is sliced at segment boundaries, so segments
            # must tile exactly into pages
            if batcher is not None and batcher.page_size is not None and SEGMENT_TOKENS % batcher.page_size:
                raise ValueError(
                    f"page_size={batcher.page_size} must divide the prefix-cache segment size "
                    f"({SEGMENT_TOKENS} tokens)"
                )
        self._promotions: set = set()  # in-flight device-tier promotions (strong refs)
        # this server's peer id, the detail of its integrity.corrupt firings:
        # a swarm in one process shares one chaos plane, whose rules single
        # out a replica by matching it
        self._peer_str = identity.peer_id.to_string() if identity is not None else ""
        self._corrupt_seed = zlib.crc32(self._peer_str.encode("utf-8"))
        # server-to-server push: session_id -> the queue of pushed steps
        self._push_queues: Dict[str, asyncio.Queue] = {}
        self._push_pool = ConnectionPool(identity=identity)
        self._push_tasks: set = set()
        # live sessions by session_id, for ptu.session_export / handoff; and
        # the host snapshots a draining server parked
        self._session_registry: Dict[str, dict] = {}
        self._parked: Dict[str, dict] = {}
        self.park_ttl = 60.0
        self.draining = False
        # KV a peer pushed here (ptu.session_migrate), held under a byte
        # budget until the client adopts it or the TTL lapses; and the
        # sessions pushed away from here, answered as redirects
        self._migrated: Dict[str, dict] = {}
        self._migrated_away: Dict[str, dict] = {}
        self._migrated_bytes = 0
        self.migrate_in_budget_bytes = 512 * 2**20
        self.migrate_ttl = 120.0
        # set at shutdown: an in-flight migration push gives up at once
        self._migrate_abort = asyncio.Event()
        # what moved through this handler: bytes and seconds of the KV
        # transfers, pushed steps served and duplicate copies skipped
        self.migration_stats = {
            "exports": 0, "export_bytes": 0, "export_s": 0.0,
            "imports": 0, "import_bytes": 0, "import_s": 0.0,
            "pushes": 0, "push_bytes": 0, "push_s": 0.0, "push_failures": 0,
            "adopts": 0, "adopt_bytes": 0, "adopt_s": 0.0,
            "pushed_steps_served": 0, "client_copies_skipped": 0, "pushed_copies_skipped": 0,
        }

    def register(self, server: RpcServer) -> None:
        server.add_unary_handler("ptu.info", self.rpc_info)
        server.add_unary_handler("ptu.forward", self.rpc_forward)
        server.add_unary_handler("ptu.backward", self.rpc_backward)
        server.add_unary_handler("ptu.probe", self.rpc_probe)
        server.add_unary_handler("ptu.push", self.rpc_push)
        server.add_unary_handler("ptu.session_export", self.rpc_session_export)
        server.add_unary_handler("ptu.session_migrate", self.rpc_session_migrate)
        server.add_unary_handler("ptu.session_handoff", self.rpc_session_handoff)
        server.add_stream_handler("ptu.inference", self.rpc_inference)

    def _occupancy(self) -> Optional[dict]:
        """The pool's occupancy for a journal event; None with no batcher."""
        return self.batcher.occupancy_info() if self.batcher is not None else None

    async def swap_backend(self, backend, batcher=None) -> None:
        """Serve a new span (a rebalance or a resize): ``backend`` over its
        weights and ``batcher``, a pool over it (None: no batching). The old
        pool closes first, its step programs dropped with it, so the budget
        holds one pool; its sessions fail at their next step and the clients
        repair, as after a pool reset. A private session opened on the old
        span keeps its backend, and so the old span's weights and graphs,
        until it closes. The new pool opens, its step programs captured on a
        card, before this returns. The prefix cache starts empty: its
        entries name the old span's blocks and pin the old pool's pages."""
        old = self.batcher
        if old is not None:
            await old.close()
        self.backend = backend
        self._sub_backends = {}
        self.batcher = batcher
        if self.prefix_cache is not None:
            self.prefix_cache = PrefixCache(
                self.prefix_cache.max_bytes, device_max_bytes=self.prefix_cache.device_max_bytes,
                policy=self.prefix_cache.policy, device=backend.device,
                swap_pool=batcher.swap_pool if batcher is not None else None,
                usage_fn=self.ledger.peer_dominant_share, ledger=self.ledger,
            )
        if batcher is not None:
            await batcher.ensure_open()

    def abort_migrations(self) -> None:
        """In-flight migration pushes give up at once (the shutdown path):
        the parked entries stay, and clients repair by export or replay."""
        self._migrate_abort.set()

    async def close(self) -> None:
        """Cancel the output pushes still in flight and close the push
        connections (the server's shutdown)."""
        self.abort_migrations()
        for task in list(self._push_tasks):
            task.cancel()
        if self._push_tasks:
            await asyncio.gather(*self._push_tasks, return_exceptions=True)
        await self._push_pool.close()

    def _parse_chain(self, uids) -> Tuple[int, int]:
        """Validate a chain of UIDs against our span; return (start, end)
        relative to the backend's first block."""
        parts = uids.split(CHAIN_DELIMITER) if isinstance(uids, str) else list(uids)
        if not parts:
            raise ValueError("Empty uid chain")
        indices = []
        for uid in parts:
            prefix, idx = parse_uid(uid)
            if prefix != self.dht_prefix:
                raise ValueError(f"UID {uid!r} does not match served prefix {self.dht_prefix!r}")
            indices.append(idx)
        lo, hi = indices[0], indices[-1] + 1
        if indices != list(range(lo, hi)):
            raise ValueError(f"UID chain must be contiguous, got {indices}")
        first, last = self.backend.first_block, self.backend.first_block + self.backend.n_blocks
        if lo < first or hi > last:
            raise ValueError(f"Requested blocks [{lo}, {hi}) outside served span [{first}, {last})")
        return lo - first, hi - first

    def _sub_backend(self, start: int, end: int) -> TransformerBackend:
        """The backend serving blocks [start, end) of the span: the span's own
        for the whole of it, else one over a slice of its parameters (views,
        no copy), cached per (start, end). Under multi-host lockstep the
        slice is wrapped in a view that the workers execute over the same
        slice (``sub_view``)."""
        if start == 0 and end == self.backend.n_blocks:
            return self.backend
        key = (start, end)
        if key not in self._sub_backends:
            sub = self.backend.sub_backend(start, end)
            if getattr(self.backend, "is_lockstep", False):
                sub = self.backend.sub_view(sub, start, end)
            self._sub_backends[key] = sub
        sub = self._sub_backends[key]
        # the adapters' blocks of the slice, as the span's own (loaded or
        # replaced after the slice was made)
        getattr(sub, "_backend", sub).adapters = {
            name: (per_block[start:end], scaling) for name, (per_block, scaling) in self.backend.adapters.items()
        }
        return sub

    def _validate_step_tensors(self, hidden, prompts, hypo_ids, batch_size: int, n_blocks: int) -> None:
        """Reject malformed step tensors with a clean error instead of an
        opaque failure inside a step."""
        hsz = self.backend.hidden_size
        if hidden is not None and (
            hidden.dim() != 3 or hidden.shape[0] != batch_size or hidden.shape[2] != hsz
        ):
            raise ValueError(
                f"step hidden must be [batch={batch_size}, seq, hidden={hsz}], got {tuple(hidden.shape)}"
            )
        if hypo_ids is not None and tuple(hypo_ids.shape) != (batch_size,):
            raise ValueError(f"hypo_ids must be [{batch_size}], got {tuple(hypo_ids.shape)}")
        if prompts is not None and (
            prompts.dim() != 4
            or prompts.shape[0] != n_blocks
            or prompts.shape[1] != batch_size
            or prompts.shape[3] != hsz
        ):
            raise ValueError(
                f"prompts must be [{n_blocks} blocks, batch={batch_size}, pre_seq, "
                f"hidden={hsz}], got {tuple(prompts.shape)}"
            )

    def _get_tensor(self, payload: dict, name: str) -> Optional[torch.Tensor]:
        wire = (payload.get("tensors") or {}).get(name)
        if wire is None:
            return None
        t = deserialize_array(wire)
        return None if is_dummy(t) else t

    def _reply_compression(self, payload: dict) -> CompressionType:
        """The client's requested codec wins over the server-wide default."""
        requested = payload.get("compression")
        if requested is None:
            return self.compression
        try:
            return CompressionType(requested)
        except ValueError:
            raise ValueError(f"Compression {requested!r} is not supported by this server") from None

    async def rpc_forward(self, payload, ctx: RpcContext):
        """A stateless forward of ``hidden`` [batch, seq, hidden] (and deep
        ``prompts`` [n_blocks, batch, pre_seq, hidden]) through the asked
        blocks, with the ``active_adapter`` if one is named: petals_tpu's
        ``rpc_forward``."""
        start, end = self._parse_chain(payload["uids"])
        reply_comp = self._reply_compression(payload)  # a bad codec is refused up front
        hidden = self._get_tensor(payload, "hidden")
        prompts = self._get_tensor(payload, "prompts")
        hsz = self.backend.hidden_size
        if hidden is None or hidden.dim() != 3 or hidden.shape[2] != hsz:
            raise ValueError(
                f"rpc_forward expects a [batch, seq, hidden={hsz}] "
                f"tensor, got {None if hidden is None else tuple(hidden.shape)}"
            )
        backend = self._sub_backend(start, end)
        adapter = payload.get("active_adapter")
        backend.params_for(adapter)  # an unknown adapter is refused up front
        size = hidden.shape[0] * hidden.shape[1]

        def run_forward():
            with device_annotation("rpc_forward"):  # on the compute thread
                return backend.forward(hidden, prompts=prompts, active_adapter=adapter).cpu()

        with get_tracer().span("rpc_forward", annotate=False, blocks=end - start, tokens=size):
            out = await asyncio.wait_for(
                self.queue.submit(run_forward, priority=PRIORITY_TRAINING, size=size), self.request_timeout
            )
        return {"tensors": {"hidden": serialize_array(out, reply_comp)}}

    async def rpc_backward(self, payload, ctx: RpcContext):
        """The gradients of the asked blocks' output, weighted by
        ``grad_out``, at their input ``hidden`` and at the deep ``prompts``:
        petals_tpu's ``rpc_backward`` (the blocks recomputed from ``hidden``
        under autograd, ``backend.backward``)."""
        start, end = self._parse_chain(payload["uids"])
        reply_comp = self._reply_compression(payload)  # a bad codec is refused up front
        hidden = self._get_tensor(payload, "hidden")
        grad_out = self._get_tensor(payload, "grad_out")
        prompts = self._get_tensor(payload, "prompts")
        if hidden is None or grad_out is None:
            raise ValueError("rpc_backward expects hidden and grad_out tensors")
        hsz = self.backend.hidden_size
        if hidden.dim() != 3 or hidden.shape[2] != hsz:
            raise ValueError(
                f"rpc_backward expects a [batch, seq, hidden={hsz}] tensor, got {tuple(hidden.shape)}"
            )
        if grad_out.shape != hidden.shape:
            raise ValueError(f"grad_out shape {tuple(grad_out.shape)} != hidden shape {tuple(hidden.shape)}")
        backend = self._sub_backend(start, end)
        adapter = payload.get("active_adapter")
        backend.params_for(adapter)  # an unknown adapter is refused up front
        size = hidden.shape[0] * hidden.shape[1]

        def run_backward():
            with device_annotation("rpc_backward"):  # on the compute thread
                grad_hidden, grad_prompts = backend.backward(hidden, grad_out, prompts=prompts,
                                                             active_adapter=adapter)
                return grad_hidden.cpu(), None if grad_prompts is None else grad_prompts.cpu()

        with get_tracer().span("rpc_backward", annotate=False, blocks=end - start, tokens=size):
            grad_hidden, grad_prompts = await asyncio.wait_for(
                self.queue.submit(run_backward, priority=PRIORITY_TRAINING, size=size), self.request_timeout
            )
        tensors = {"grad_hidden": serialize_array(grad_hidden, reply_comp)}
        if grad_prompts is not None:
            tensors["grad_prompts"] = serialize_array(grad_prompts, reply_comp)
        return {"tensors": tensors}

    async def rpc_probe(self, payload, ctx: RpcContext):
        """The integrity canary probe: a caller-seeded golden input through
        the whole span's forward, answered with the fingerprint of its last
        row. The caller picks the seed, so a replica cannot precompute or
        replay an honest digest; a prober compares the digests of every
        replica of a span by quorum (telemetry/integrity.py)."""
        seed = int(payload.get("seed", fp_ops.fp_seed()))
        n_tokens = max(1, min(int(payload.get("tokens", 4)), 16))
        hsz = self.backend.hidden_size
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        # activation-scale golden input: magnitudes typical of embedding outputs
        hidden = (rng.standard_normal((1, n_tokens, hsz)) * 0.02).astype(np.float32)
        backend = self.backend

        def run_probe():
            with device_annotation("rpc_probe"):
                return backend.forward(hidden).float().cpu().numpy()

        with get_tracer().span("rpc_probe", annotate=False, blocks=backend.n_blocks, tokens=n_tokens):
            out = await asyncio.wait_for(
                self.queue.submit(run_probe, priority=PRIORITY_TRAINING, size=n_tokens), self.request_timeout
            )
        if chaos.ENABLED and chaos.fire(chaos.SITE_INTEGRITY_CORRUPT, detail=f"{self._peer_str}:probe") == "corrupt":
            out = chaos.corrupt_array(out, site_seed=self._corrupt_seed, position=n_tokens)
        fp = fp_ops.fingerprint_output(out, hsz)
        return {
            "fp": fp_ops.fp_list(fp),
            "seed": seed,
            "tokens": n_tokens,
            "fp_seed": fp_ops.fp_seed(),
            "first_block": backend.first_block,
            "n_blocks": backend.n_blocks,
        }

    async def rpc_info(self, payload, ctx: RpcContext):
        info = dict(self.server_info_fn()) if self.server_info_fn is not None else {}
        info |= {
            "first_block": self.backend.first_block,
            "n_blocks": self.backend.n_blocks,
            "dht_prefix": self.dht_prefix,
            "inference_max_length": self.inference_max_length,
            "quant_type": self.backend.quant_type,  # petals_tpu's ServerInfo.quant_type
            "kv_quant": self.backend.kv_quant_type,
            "tracing": get_tracer().summary(),
            # the digest the announce carries, and the step-program
            # observatory's (a capture standing for a compile)
            "telemetry": telemetry_digest(),
            "compile_stats": get_observatory().compile_stats(),
            # free bytes over the LOGICAL (floating-point) bytes a token, as
            # petals_tpu's rpc_info answers; the announce's cache_tokens_left
            # counts stored bytes (server.py)
            "cache_tokens_available": max(
                self.memory_cache.bytes_left // max(self.backend.cache_bytes_per_token(), 1), 0
            ),
        }
        b = self.batcher
        if b is not None:  # petals_tpu answers without these under --no_batching
            info["continuous_batching"] = {
                "lanes": b.n_lanes,
                "max_length": b.max_length,
                "page_size": b.page_size,
                "n_pages": b.n_pages,
                "prefill_token_budget": b.prefill_token_budget,
                **b.pool_info(),
                **b.stats,
            }
            paged = b.paged_summary()
            if paged is not None:
                info["continuous_batching"]["paged"] = paged
            # lanes, pages, suspended sessions, swap bytes, preemptions: the
            # dict ServerInfo.pool carries too
            info["pool"] = b.occupancy_info()
        if self.prefix_cache is not None:
            info["prefix_cache"] = self.prefix_cache.summary()
        return info

    async def rpc_inference(self, requests, ctx: RpcContext):
        """Bidirectional inference stream: open -> step* -> end."""
        open_msg = await asyncio.wait_for(anext(requests), self.step_timeout)
        if self.draining:
            raise RuntimeError("Server is draining: not accepting new sessions")
        client_version = open_msg.get("client_version")
        if client_version is not None and not is_compatible(client_version):
            raise ValueError(incompatibility_error(client_version, peer="client"))
        start, end = self._parse_chain(open_msg["uids"])
        max_length = int(open_msg["max_length"])
        if self.inference_max_length is not None and max_length > self.inference_max_length:
            raise ValueError(
                f"max_length {max_length} exceeds this server's inference_max_length "
                f"{self.inference_max_length}"
            )
        batch_size = int(open_msg.get("batch_size", 1))
        reply_comp = self._reply_compression(open_msg)
        active_adapter = open_msg.get("active_adapter")
        trace_id = normalize_trace_id(open_msg.get("trace_id")) or new_trace_id()
        t_session = time.perf_counter()  # TTFT runs from here to the first content reply
        session_id = open_msg.get("session_id")
        # where to push each step's output: {"addr": "host:port/peer", "session_id": ...}
        push_to = open_msg.get("push_to") or None
        # whom the session bills to (fair-share admission, the ledger): a
        # PROVEN identity wins; else the open message's unauthenticated
        # peer_hint, which can only split its sender's own bill
        proven = getattr(ctx, "remote_peer_id", None)
        if proven is not None:
            peer: Optional[str] = proven.to_string()
        else:
            hint = open_msg.get("peer_hint")
            peer = str(hint)[:64] if hint else None
        backend = self._sub_backend(start, end)
        backend.params_for(active_adapter)  # an unknown adapter is refused up front
        batcher = self.batcher
        alloc_timeout = open_msg.get("alloc_timeout")
        lane: Optional[int] = None
        t_open = time.perf_counter()
        if (batcher is not None and batch_size == 1 and active_adapter is None
                and (start, end) == (0, self.backend.n_blocks) and max_length <= batcher.max_length):
            try:
                lane = await batcher.acquire_lane(
                    timeout=30.0 if alloc_timeout is None else alloc_timeout,
                    priority=parse_session_priority(open_msg.get("priority")),
                    peer_id=peer, trace_id=trace_id,
                )
            except AllocationFailed as e:
                logger.debug(f"No decode lane ({e}); serving with a private cache")
        open_wait_s = time.perf_counter() - t_open
        if lane is not None:
            cache_ctx = self._lane_ctx(lane, batcher)
        else:
            cache_ctx = self._private_cache_ctx(backend, batch_size, max_length, alloc_timeout)
        async with cache_ctx as handles:
            # a private cache is (k_stack, v_stack), written in place; a
            # pooled session's KV lives in the batcher's pool, keyed by lane
            kv = tuple(self.memory_cache.get_buffers(*handles)) if lane is None else None
            push_queue: Optional[asyncio.Queue] = None
            reg = None
            if session_id:
                # registered once the cache exists, so a failed open leaks nothing
                push_queue = asyncio.Queue(maxsize=64)
                self._push_queues[session_id] = push_queue
                reg = {
                    "lane": lane, "batcher": batcher, "kv": kv, "position": 0,
                    "start": self.backend.first_block + start, "end": self.backend.first_block + end,
                    "batch_size": batch_size, "max_length": max_length,
                    "trace_id": trace_id, "peer": peer,
                }
                self._session_registry[session_id] = reg
            yield {
                "session_open": True, "position": 0, "max_length": max_length,
                "trace_id": trace_id, "open_wait_s": round(open_wait_s, 6),
            }
            next_step, cleanup_steps = self._step_source(requests, push_queue, self.session_timeout)
            seen_steps = set()  # the same step may come from the client and from a push
            position = 0
            pending_store = None  # the in-flight prefix-cache store
            stats = self.migration_stats
            ttft_observed = False
            # every span of this session carries its trace id
            trace_token = set_trace_id(trace_id)
            try:
                while True:
                    step, pushed = await next_step()
                    t_recv = time.perf_counter()
                    # a later step may roll back or overwrite the rows being
                    # stored, and the session's end releases them: the store
                    # finishes first
                    if pending_store is not None:
                        with contextlib.suppress(Exception):
                            await pending_store
                        pending_store = None
                    if step is None:
                        break
                    if chaos.ENABLED:
                        # a fault at the step boundary, before the step is
                        # queued: the stream dies where a session's KV is
                        # most exposed
                        await chaos.inject(chaos.SITE_HANDLER_STEP, detail=session_id)
                    if self.draining:
                        # fail fast, so that the client repairs its chain while
                        # the parked export is still served
                        raise RuntimeError("Server is draining: migrate this session via ptu.session_export")
                    if "push_to" in step:  # a chain repair moved the next server
                        push_to = step["push_to"] or None
                    step_id = step.get("step_id")
                    if step_id is not None:
                        if step_id in seen_steps:
                            stats["pushed_copies_skipped" if pushed else "client_copies_skipped"] += 1
                            continue
                        seen_steps.add(step_id)
                    if pushed:
                        stats["pushed_steps_served"] += 1
                    if "kv_adopt" in step or "kv_import" in step:
                        kind = "kv_adopt" if "kv_adopt" in step else "kv_import"
                        if kind == "kv_adopt":
                            position = await self._install_kv_adopt(
                                step, backend, batcher, lane, kv, position,
                                abs_start=self.backend.first_block + start, batch_size=batch_size,
                                n_blocks=end - start, max_length=max_length,
                            )
                        else:
                            position = await self._install_kv_import(
                                step, backend, batcher, lane, kv, position,
                                batch_size=batch_size, n_blocks=end - start, max_length=max_length,
                            )
                        if reg is not None:
                            reg["position"] = position
                        yield {"position": position, kind: True}
                        continue
                    position, reply, pending_store = await self._serve_step(
                        step, t_recv, ctx, backend, batcher, lane, kv, (start, end), batch_size, max_length,
                        position, reply_comp, peer, push_to, active_adapter, session_id,
                    )
                    if reg is not None:
                        reg["position"] = position
                    if not ttft_observed and (reply.get("tokens") or reply.get("tensors")):
                        # the session's first content reply: open to first
                        # token out, queue wait and prefill included
                        ttft_observed = True
                        tm.TTFT.observe(time.perf_counter() - t_session)
                    yield reply
            finally:
                reset_trace_id(trace_token)
                if pending_store is not None:
                    # a failure or a cancellation: the store is dropped now,
                    # and releases its pins on the way out
                    pending_store.cancel()
                await cleanup_steps()
                if session_id:
                    if self._push_queues.get(session_id) is push_queue:
                        self._push_queues.pop(session_id, None)
                    if self._session_registry.get(session_id) is reg:
                        self._session_registry.pop(session_id, None)

    @staticmethod
    def _step_source(requests, push_queue, timeout):
        """(next_step, cleanup): ``next_step()`` returns (the next step,
        whether it was pushed) from whichever comes first, the client's
        stream or the push queue; (None, False) once the client
        half-closed. The pending reads persist across calls, and the client
        stream is read straight, so the transport's bounded inbound queue is
        the only buffer (petals_tpu/server/handler.py:2205)."""
        pending: Dict[str, asyncio.Task] = {}

        async def next_client():
            try:
                return await anext(requests)
            except StopAsyncIteration:
                return None  # the client half-closed
            except Exception as e:
                logger.debug(f"Client stream error (treated as a half-close): {e!r}")
                return None

        async def next_step():
            if "client" not in pending:
                pending["client"] = asyncio.create_task(next_client())
            if push_queue is not None and "push" not in pending:
                pending["push"] = asyncio.create_task(push_queue.get())
            done, _ = await asyncio.wait(set(pending.values()), timeout=timeout, return_when=asyncio.FIRST_COMPLETED)
            if not done:
                await cleanup()
                raise asyncio.TimeoutError("No inference step within session_timeout")
            # the client's read first when both are ready: its half-close
            # must not wait behind a push
            name = "client" if pending.get("client") in done else "push"
            task = pending.pop(name)
            return task.result(), name == "push"

        async def cleanup():
            for task in pending.values():
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await task
            pending.clear()

        return next_step, cleanup

    async def _serve_step(self, step, t_recv, ctx, backend, batcher, lane, kv, span, batch_size, max_length,
                          position, reply_comp, peer, push_to=None, active_adapter=None, session_id=None):
        """One step of a session: returns (the new position, the reply, the
        prefix store it started or None). A reply of hidden states to a step
        without deep prompts is also pushed to ``push_to``, after it is
        serialized and off its path. An adapter session's steps apply
        ``active_adapter`` and skip the prefix cache."""
        start, end = span
        start_from = step.get("start_from_position")
        if start_from is not None:
            if not 0 <= int(start_from) <= position:
                raise ValueError(f"start_from_position {start_from} is outside the cache [0, {position}]")
            position = int(start_from)  # rollback: later rows are overwritten
        hidden = self._get_tensor(step, "hidden")
        prompts = self._get_tensor(step, "prompts")
        hypo_ids = self._get_tensor(step, "hypo_ids")
        self._validate_step_tensors(hidden, prompts, hypo_ids, batch_size, end - start)
        if hidden is None or hidden.shape[1] == 0:
            return position, {"tensors": {}, "position": position}, None  # cache probe
        seq = hidden.shape[1]
        if position + seq > max_length:
            raise ValueError(f"Step of {seq} tokens at position {position} exceeds max_length {max_length}")
        gen_n, gen_sampling = self._gen_request(step, span, batch_size, prompts, hypo_ids, position + seq, max_length)
        t_exec = time.perf_counter()
        keys, n_hit, prefix_out = None, 0, None
        if (
            self.prefix_cache is not None and position == 0 and batch_size == 1 and prompts is None
            and hypo_ids is None and active_adapter is None and seq >= SEGMENT_TOKENS
            # "peer" scope isolates clients by their proven identity: a client
            # without one is not cached at all (a shared salt would merge them
            # back into one timing-observable pool)
            and (self.prefix_share_scope == "swarm" or getattr(ctx, "remote_peer_id", None) is not None)
        ):
            salt = f"{self.dht_prefix}:{self.backend.first_block + start}:{self.backend.first_block + end}"
            if self.prefix_share_scope == "peer":
                salt += f":{ctx.remote_peer_id.to_string()}"
            keys = await asyncio.to_thread(segment_keys, hidden, salt)
            # probe and entry resolution with no await between: a concurrent
            # put()'s eviction cannot pop a probed key before its entry is held
            n_hit = self.prefix_cache.probe(keys)
            if n_hit:
                entries = self.prefix_cache.get_entries(keys, n_hit)
                # swarmlint: disable=paired-refcount — ownership transfer: the pages _seed_prefix adopts belong to the lane's table row; release_lane / copy-on-write decref them
                prefix_out = await self._seed_prefix(backend, batcher, lane, kv, keys, entries)
        hit_len = n_hit * SEGMENT_TOKENS
        if hit_len == seq:
            # the whole prefill was cached: nothing runs on the device
            out, variant, timing, step_fp = prefix_out, "cached", None, None
        else:
            with get_tracer().span("inference_step", annotate=False, blocks=end - start, batch=batch_size, seq=seq):
                out, variant, timing, step_fp = await asyncio.wait_for(
                    self._run_step(backend, batcher, lane, kv, hidden[:, hit_len:], position + hit_len, prompts,
                                   hypo_ids, active_adapter),
                    self.step_timeout,
                )
            if prefix_out is not None:  # the cached outputs ahead of the tail's
                out = torch.cat([prefix_out.to(out.dtype), out], dim=1)
        if timing is None:  # not a coalesced step: the execution wall, queue included
            timing = {"queue_s": 0.0, "compute_s": time.perf_counter() - t_exec}
        pending_store = None
        if keys is not None and len(keys) > n_hit:
            pending_store = self._maybe_store(backend, batcher, lane, kv, keys, n_hit, out, end - start, peer)
        position += seq
        if gen_n:
            t_gen = time.perf_counter()
            tokens, gen_timing = await asyncio.wait_for(
                self._generate(backend, batcher, lane, kv, out[:, -1:], position, gen_n, gen_sampling,
                               active_adapter),
                self.step_timeout,
            )
            if lane is not None:
                # a token reply carries no hidden state to digest: the
                # generation steps' fingerprint must not ride a later reply
                batcher.pop_step_fp(lane)
            if gen_timing is not None:  # the batcher's steps: the two phases sum
                timing = {"queue_s": timing.get("queue_s", 0.0) + gen_timing["queue_s"],
                          "compute_s": timing.get("compute_s", 0.0) + gen_timing["compute_s"]}
                # a stream that speculated: its acceptance survives the merge
                timing.update({k: gen_timing[k] for k in SPEC_META_KEYS if k in gen_timing})
                variant += "+gen"
            else:
                timing = {**timing, "compute_s": timing.get("compute_s", 0.0) + time.perf_counter() - t_gen}
            position += gen_n - 1  # the last token is never fed
            step_meta = {
                "queue_s": round(timing["queue_s"], 6), "compute_s": round(timing["compute_s"], 6),
                "variant": variant, "serialize_s": 0.0, "total_s": round(time.perf_counter() - t_recv, 6),
                **{k: timing[k] for k in SPEC_META_KEYS if k in timing},
            }
            self._lane_meta(step_meta, batcher, lane)
            return position, {"tokens": [int(t) for t in tokens[0]], "position": position,
                              "step_meta": step_meta}, pending_store
        if chaos.ENABLED and chaos.fire(
            chaos.SITE_INTEGRITY_CORRUPT, detail=f"{self._peer_str}:{session_id or 'anon'}"
        ) == "corrupt":
            # seeded corruption of the host copy at the reply boundary: the
            # wire output then disagrees with the fused fingerprint of its
            # own step_meta, which is what the client's cross-check catches
            out = chaos.corrupt_array(out, site_seed=self._corrupt_seed, position=position)
        t_ser = time.perf_counter()
        wire_out = serialize_array(out, reply_comp)
        ser_s = time.perf_counter() - t_ser
        tm.REPLY_SERIALIZE.observe(ser_s)
        step_meta = {
            "queue_s": round(timing.get("queue_s", 0.0), 6),
            "compute_s": round(timing.get("compute_s", 0.0), 6),
            "variant": variant,
            "serialize_s": round(ser_s, 6),
            "total_s": round(time.perf_counter() - t_recv, 6),
        }
        if step_fp is not None:
            # the step program's fused digest of the reply's last row: the
            # client re-derives it from the hidden state it receives
            step_meta["fp"] = step_fp
        if push_to is not None and prompts is None:
            # fire and forget: the client's relayed copy still counts (the
            # next server serves whichever comes first), so a slow or dead
            # peer must never delay this reply
            task = asyncio.create_task(self._push_outputs(push_to, wire_out, step))
            self._push_tasks.add(task)
            task.add_done_callback(self._push_tasks.discard)
        self._lane_meta(step_meta, batcher, lane)
        return position, {"tensors": {"hidden": wire_out}, "position": position, "step_meta": step_meta}, pending_store

    async def _push_outputs(self, push_to: dict, wire_out, step: dict) -> None:
        """Send a step's output straight to the next server's session, with
        the step's id, hypo_ids and rollback marker, under petals_tpu's key
        set. A failure is only logged: the client's copy still flows."""
        try:
            payload = {"session_id": push_to["session_id"], "step_id": step.get("step_id"),
                       "tensors": {"hidden": wire_out}}
            wire_hypo = (step.get("tensors") or {}).get("hypo_ids")
            if wire_hypo is not None:  # a beam reorder must survive the push
                payload["tensors"]["hypo_ids"] = wire_hypo
            if step.get("start_from_position") is not None:
                payload["start_from_position"] = int(step["start_from_position"])
            client = await self._push_pool.get_addr(PeerAddr.from_string(push_to["addr"]))
            await asyncio.wait_for(client.call("ptu.push", payload), 10.0)
        except Exception as e:
            logger.debug(f"Push to the next server failed (the client's copy still flows): {e!r}")

    async def rpc_push(self, payload, ctx: RpcContext):
        """A step pushed by the previous server of a chain, for the session
        ``payload["session_id"]`` (petals_tpu/server/handler.py:267)."""
        session_id = payload.get("session_id")
        queue = self._push_queues.get(session_id)
        if queue is None:
            raise KeyError(f"No active inference session {session_id!r} on this server")
        try:
            queue.put_nowait(payload)
        except asyncio.QueueFull:
            # best effort: refusing beats buffering a runaway upstream's backlog
            raise RuntimeError(f"Push queue full for session {session_id!r}") from None
        return {"ok": True}

    @staticmethod
    def _lane_meta(step_meta: dict, batcher, lane: Optional[int]) -> None:
        """A pooled reply's load hint and the session's bill since its last
        reply (``usage``, summed by the clients' ``usage_report``)."""
        if lane is None:
            return
        step_meta.update(batcher.occupancy_hint())
        usage = batcher.pop_usage_delta(lane)
        if usage:
            step_meta["usage"] = usage

    # ------------------------------------------------------------------ migration

    async def _snapshot_session(self, reg: dict, b0: Optional[int] = None, b1: Optional[int] = None) -> dict:
        """Host copy of a live session's KV, blocks [b0, b1) of its span
        (all by default), rows [0, its position): (k, v) [blocks, batch,
        position, hkv, d] CPU tensors (a quantized pool's rows decoded). A
        pooled lane is read by the batcher, from its swap entry when it is
        suspended (a swap-in only to read bytes already on the host would
        cost pages and two copies); a private cache is copied on the compute
        queue, ordered against the steps that write it in place."""
        n = reg["end"] - reg["start"]
        b0 = 0 if b0 is None else b0
        b1 = n if b1 is None else b1
        position = reg["position"]
        if reg["lane"] is not None:
            batcher = reg["batcher"]
            pair = await batcher.snapshot_from_swap(reg["lane"], position, b0, b1)
            if pair is None:
                pair = await batcher.snapshot_lane(reg["lane"], position, b0, b1)
        else:
            def read():
                if getattr(self.backend, "is_lockstep", False):
                    # the shards live on every process: the group's export
                    return self.backend.export_kv(reg["kv"], b0, b1, position)
                return tuple(t[b0:b1, :, :position].to("cpu", copy=True) for t in reg["kv"])

            pair = await self.queue.submit(read, priority=PRIORITY_INFERENCE, size=0)
        k, v = pair
        return {
            "k": k, "v": v, "position": position, "start": reg["start"], "end": reg["end"],
            "batch_size": reg["batch_size"], "max_length": reg["max_length"],
        }

    async def park_sessions(self, ttl: Optional[float] = None) -> int:
        """Snapshot every live session's KV into host memory (the drain
        path: the streams die with the server, the exports must not).
        Returns how many sessions were parked."""
        ttl = self.park_ttl if ttl is None else ttl
        parked = 0
        for session_id, reg in list(self._session_registry.items()):
            if reg["position"] <= 0:
                continue
            try:
                snap = await self._snapshot_session(reg)
            except Exception as e:
                logger.warning(f"Could not park session {session_id!r}: {e!r}")
                continue
            snap |= {"expires": time.monotonic() + ttl, "trace_id": reg.get("trace_id"), "peer": reg.get("peer")}
            self._parked[session_id] = snap
            parked += 1
        return parked

    def _prune_parked(self) -> None:
        now = time.monotonic()
        for sid in [s for s, p in self._parked.items() if p.get("expires", 0) < now]:
            del self._parked[sid]

    def _prune_migrated(self) -> None:
        now = time.monotonic()
        for sid in [s for s, m in self._migrated.items() if m["expires"] < now]:
            self._migrated_bytes -= self._migrated[sid]["nbytes"]
            del self._migrated[sid]

    def _consume_migrated(self, session_id: str) -> None:
        entry = self._migrated.pop(session_id, None)
        if entry is not None:
            self._migrated_bytes -= entry["nbytes"]

    async def rpc_session_export(self, payload, ctx: RpcContext):
        """A session's KV, sliced to its position and to blocks [start,
        end), for a client seeding a replacement without recomputing the
        prefill: a live session's, a parked one's or a migrated-in entry's;
        or a ``migrated_to`` redirect for a session pushed away."""
        t0 = time.perf_counter()
        session_id = payload.get("session_id")
        want_start, want_end = int(payload["start"]), int(payload["end"])
        comp = CompressionType(payload.get("compression", "none"))
        self._prune_parked()
        # the copy at the destination is the authoritative one now, even
        # while the drained stream is still open
        fwd = self._migrated_away.get(session_id)
        if fwd is not None:
            return {"migrated_to": dict(fwd)}
        # live first: a parked snapshot goes stale if steps kept flowing
        live = self._session_registry.get(session_id)
        if live is not None:
            if not live["start"] <= want_start < want_end <= live["end"]:
                raise ValueError(
                    f"Requested blocks [{want_start}, {want_end}) outside session span "
                    f"[{live['start']}, {live['end']})"
                )
            # only the asked blocks leave the device
            src = await self._snapshot_session(live, want_start - live["start"], want_end - live["start"])
            b0, b1 = 0, want_end - want_start
        else:
            self._prune_migrated()
            src = self._parked.get(session_id) or self._migrated.get(session_id)
            if src is None:
                raise KeyError(f"No live or parked session {session_id!r}")
            if not src["start"] <= want_start < want_end <= src["end"]:
                raise ValueError(
                    f"Requested blocks [{want_start}, {want_end}) outside session span "
                    f"[{src['start']}, {src['end']})"
                )
            b0, b1 = want_start - src["start"], want_end - src["start"]
        position = src["position"]
        if position <= 0:
            raise ValueError(f"Session {session_id!r} has no cached tokens yet")
        # a migrated-in entry may hold packed codes and scales: the export
        # stays dense on the wire
        kv_quant = src.get("kv_quant") or "none"

        def dense(name: str):
            arr = src[name][b0:b1]
            if kv_quant != "none":
                arr = torch.from_numpy(dequantize_kv_np(arr.numpy(), src[name + "_scales"][b0:b1].numpy(), kv_quant))
            return serialize_array(arr, comp)

        k_wire, v_wire = await asyncio.to_thread(lambda: (dense("k"), dense("v")))
        stats = self.migration_stats
        stats["exports"] += 1
        stats["export_bytes"] += len(k_wire["data"]) + len(v_wire["data"])
        stats["export_s"] += time.perf_counter() - t0
        return {
            "position": position, "start": want_start, "end": want_end, "batch_size": src["batch_size"],
            "tensors": {"k": k_wire, "v": v_wire},
        }

    async def rpc_session_migrate(self, payload, ctx: RpcContext):
        """A session's KV pushed here by a draining (or handing-off) peer,
        held in host memory under ``migrate_in_budget_bytes`` until the
        client opens here and adopts it (``kv_adopt``), exports it onward,
        or ``migrate_ttl`` lapses. A packed entry (``kv_quant``) is kept as
        it came."""
        session_id = payload["session_id"]
        src_start, src_end = int(payload["start"]), int(payload["end"])
        position = int(payload["position"])
        batch_size = int(payload["batch_size"])
        max_length = int(payload["max_length"])
        trace_id = normalize_trace_id(payload.get("trace_id"))
        if self.draining:
            raise RuntimeError("Server is draining: not accepting migrated sessions")
        first = self.backend.first_block
        if not first <= src_start < src_end <= first + self.backend.n_blocks:
            raise ValueError(
                f"Migrated span [{src_start}, {src_end}) outside this server's "
                f"blocks [{first}, {first + self.backend.n_blocks})"
            )
        if position <= 0:
            raise ValueError("Refusing to migrate a session with no cached tokens")
        tensors = payload.get("tensors") or {}
        if "k" not in tensors or "v" not in tensors:
            raise ValueError("session_migrate needs k and v tensors")
        kv_quant = str(payload.get("kv_quant") or "none")
        if kv_quant not in KV_QUANT_KINDS:
            raise ValueError(f"Unknown kv_quant {kv_quant!r} in session_migrate")
        names = ("k", "v") if kv_quant == "none" else ("k", "v", "k_scales", "v_scales")
        if any(name not in tensors for name in names):
            raise ValueError("quantized session_migrate needs k_scales and v_scales tensors")
        want = (src_end - src_start, batch_size, position)

        def parse():
            arrs = {}
            for name in names:
                arr = deserialize_array(tensors[name])
                if tuple(arr.shape[:3]) != want:
                    raise ValueError(f"migrated KV shape {tuple(arr.shape)} != (blocks, batch, position) {want}")
                arrs[name] = arr
            return arrs

        arrs = await asyncio.to_thread(parse)
        nbytes = sum(a.numel() * a.element_size() for a in arrs.values())
        self._prune_migrated()
        if self._migrated_bytes + nbytes > self.migrate_in_budget_bytes:
            tm.MIGRATIONS.labels(direction="in", outcome="refused").inc()
            get_journal().event(
                "migrate_refused", trace_id=trace_id, session_id=session_id,
                nbytes=nbytes, in_use=self._migrated_bytes, budget=self.migrate_in_budget_bytes,
            )
            raise RuntimeError(
                f"Migration budget exhausted ({self._migrated_bytes + nbytes} > {self.migrate_in_budget_bytes} bytes)"
            )
        self._consume_migrated(session_id)  # a re-push after a failed adopt replaces the entry
        self._migrated[session_id] = {
            "k": arrs["k"], "v": arrs["v"], "k_scales": arrs.get("k_scales"), "v_scales": arrs.get("v_scales"),
            "kv_quant": kv_quant, "position": position, "start": src_start, "end": src_end,
            "batch_size": batch_size, "max_length": max_length, "trace_id": trace_id, "nbytes": nbytes,
            "expires": time.monotonic() + self.migrate_ttl,
        }
        self._migrated_bytes += nbytes
        tm.MIGRATIONS.labels(direction="in", outcome="ok").inc()
        tm.MIGRATION_BYTES.labels(direction="in").inc(nbytes)
        get_journal().event(
            "migrate_in", trace_id=trace_id, occupancy=self._occupancy(),
            session_id=session_id, position=position, nbytes=nbytes, start=src_start, end=src_end,
        )
        return {"ok": True, "position": position}

    async def rpc_session_handoff(self, payload, ctx: RpcContext):
        """The prefill-to-decode boundary: push one LIVE session's KV to a
        decode-tier replica (the client, between steps, then adopts it
        there). The session stays live here and no redirect is installed,
        so a failed push or adopt degrades to decoding on this server."""
        session_id = payload["session_id"]
        deadline_s = min(max(float(payload.get("deadline_s") or 30.0), 0.1), 120.0)
        reg = self._session_registry.get(session_id)
        if reg is None:
            raise KeyError(f"No live session {session_id!r} to hand off")
        if reg["position"] <= 0:
            raise ValueError(f"Session {session_id!r} has no cached tokens yet")
        snap = await self._snapshot_session(reg)
        snap |= {"trace_id": reg.get("trace_id"), "peer": reg.get("peer")}
        ok = await self.migrate_parked_to(
            session_id, snap, str(payload["peer_id"]), str(payload["addr"]), deadline_s=deadline_s, kind="handoff",
        )
        return {"ok": bool(ok), "position": int(snap["position"])}

    async def migrate_parked_to(self, session_id: str, snap: dict, peer_id: str, addr: str, *,
                                deadline_s: float = 30.0, budget_bytes: Optional[int] = None,
                                kind: str = "migrate") -> bool:
        """Push one session snapshot's KV to a live replica's
        ``ptu.session_migrate``. ``kind="migrate"`` (drain): on success the
        parked copy becomes a ``migrated_to`` redirect. ``kind="handoff"``:
        the source stays live, with no redirect. A quantized pool packs the
        rows (codes with the server's compression, which passes integers
        through; scales uncompressed, so the entry crosses byte-exact).
        The deadline covers the whole push, serialization included, and
        shutdown's abort ends it at once. Returns False when the push fails
        or is aborted: the entry stays, and the client falls back to export
        or replay (migrate) or to decoding on the source (handoff)."""
        assert kind in ("migrate", "handoff"), kind
        handoff = kind == "handoff"
        kv_quant = self.backend.kv_quant_type
        t0 = time.perf_counter()
        trace_id = snap.get("trace_id")

        def note_outcome(outcome: str, nbytes: int = 0) -> None:
            if handoff:
                tm.HANDOFFS.labels(outcome=outcome).inc()
                if outcome == "ok":
                    tm.HANDOFF_BYTES.inc(nbytes)
            else:
                tm.MIGRATIONS.labels(direction="out", outcome=outcome).inc()
                if outcome == "ok":
                    tm.MIGRATION_BYTES.labels(direction="out").inc(nbytes)

        def pack():
            if kv_quant == "none":
                return {"k": snap["k"], "v": snap["v"]}
            kc, ks = quantize_kv_rows_np(snap["k"].float().numpy(), kv_quant)
            vc, vs = quantize_kv_rows_np(snap["v"].float().numpy(), kv_quant)
            return {"k": kc, "v": vc, "k_scales": ks, "v_scales": vs}

        packed = await asyncio.to_thread(pack)
        nbytes = int(sum(a.nbytes if isinstance(a, np.ndarray) else a.numel() * a.element_size()
                         for a in packed.values()))

        async def push() -> None:
            if budget_bytes is not None and nbytes > budget_bytes:
                raise RuntimeError(f"session KV ({nbytes}B) exceeds the migration budget ({budget_bytes}B)")
            if chaos.ENABLED:  # inside the push's deadline
                await chaos.inject(chaos.SITE_HANDOFF_PUSH if handoff else chaos.SITE_MIGRATE_PUSH,
                                   detail=session_id)
            tensors = await asyncio.to_thread(lambda: {
                name: serialize_array(arr, self.compression if name in ("k", "v") else CompressionType.NONE)
                for name, arr in packed.items()
            })
            body = {
                "session_id": session_id, "start": snap["start"], "end": snap["end"],
                "position": snap["position"], "batch_size": snap["batch_size"], "max_length": snap["max_length"],
                "trace_id": snap.get("trace_id"), "kv_quant": kv_quant, "tensors": tensors,
            }
            client = await self._push_pool.get_addr(PeerAddr.from_string(addr))
            await client.call("ptu.session_migrate", body)

        push_task = asyncio.create_task(push())
        abort_task = asyncio.create_task(self._migrate_abort.wait())
        try:
            await asyncio.wait({push_task, abort_task}, timeout=deadline_s, return_when=asyncio.FIRST_COMPLETED)
        finally:
            abort_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await abort_task
        stats = self.migration_stats
        if not push_task.done():
            reason = "shutdown" if self._migrate_abort.is_set() else "deadline"
            push_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await push_task
            stats["push_failures"] += 1
            note_outcome("aborted")
            get_journal().event(
                "handoff_aborted" if handoff else "migrate_aborted", trace_id=trace_id, session_id=session_id,
                dest=peer_id, nbytes=nbytes, reason=reason, elapsed_s=time.perf_counter() - t0,
            )
            logger.warning(f"{kind.capitalize()} of {session_id!r} to {peer_id} aborted ({reason})")
            return False
        try:
            push_task.result()
        except Exception as e:
            stats["push_failures"] += 1
            note_outcome("failed")
            get_journal().event(
                "handoff_failed" if handoff else "migrate_failed", trace_id=trace_id, session_id=session_id,
                dest=peer_id, nbytes=nbytes, error=repr(e),
            )
            recorder = flight_from_env()  # None unless an SLO is configured
            if recorder is not None:
                recorder.record(
                    "handoff_failed" if handoff else "migrate_failed", trace_id=trace_id,
                    journal=lambda: get_journal().events(trace_id=trace_id)[-50:],
                    session_id=session_id, dest_peer=peer_id, dest_addr=addr, nbytes=nbytes, error=repr(e),
                    elapsed_s=time.perf_counter() - t0,
                )
            logger.warning(f"{kind.capitalize()} of {session_id!r} to {peer_id} failed: {e!r}")
            return False
        if not handoff:
            self._migrated_away[session_id] = {"peer_id": peer_id, "addr": addr, "position": snap["position"]}
            self._parked.pop(session_id, None)
        stats["pushes"] += 1
        stats["push_bytes"] += nbytes
        stats["push_s"] += time.perf_counter() - t0
        # the parked session's ledger session already closed (a handoff
        # source keeps its own bill): the bytes go to the owning peer's rollup
        self.ledger.note_migrated(None, nbytes, peer_id=snap.get("peer"))
        note_outcome("ok", nbytes)
        get_journal().event(
            "handoff_out" if handoff else "migrate_out", trace_id=trace_id,
            occupancy=self._occupancy(), session_id=session_id, dest=peer_id, nbytes=nbytes,
            position=snap["position"], elapsed_s=time.perf_counter() - t0,
        )
        return True

    async def _install_kv_import(self, step, backend, batcher, lane, kv, position, *, batch_size: int,
                                 n_blocks: int, max_length: int) -> int:
        """A ``kv_import`` first step: seed the session's lane or private
        cache from another server's exported KV. Returns the new position."""
        t0 = time.perf_counter()
        if position != 0:
            raise ValueError("kv_import must be the first step of a session")
        new_position = int(step["kv_import"]["position"])
        if not 0 < new_position <= max_length:
            raise ValueError(f"kv_import position {new_position} outside (0, {max_length}]")
        tensors = step.get("tensors") or {}
        if "k" not in tensors or "v" not in tensors:
            raise ValueError("kv_import needs k and v tensors")
        want_shape = (n_blocks, batch_size, new_position, backend.num_kv_heads, backend.head_dim)

        def parse(name):
            arr = deserialize_array(tensors[name])
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"kv_import {name} shape {tuple(arr.shape)} != {want_shape}")
            return arr

        k, v = await asyncio.to_thread(lambda: (parse("k"), parse("v")))
        await self._seed_kv(backend, batcher, lane, kv, [k], [v])
        stats = self.migration_stats
        stats["imports"] += 1
        stats["import_bytes"] += len(tensors["k"]["data"]) + len(tensors["v"]["data"])
        stats["import_s"] += time.perf_counter() - t0
        return new_position

    async def _install_kv_adopt(self, step, backend, batcher, lane, kv, position, *, abs_start: int,
                                batch_size: int, n_blocks: int, max_length: int) -> int:
        """A ``kv_adopt`` first step: seed a fresh session from KV already
        on this server, a migrated-in entry or a parked snapshot; only ids
        cross the client's link. A packed entry is decoded, and a quantized
        pool encodes the rows again as they land. The seed goes through
        ``run_exclusive`` like every lane write outside a step, which swaps
        a lane suspended before its first step back in first. The entry is
        consumed only once the seed landed; the adopted wire bytes bill to
        the lane's ledger session. Returns the new position."""
        t0 = time.perf_counter()
        if position != 0:
            raise ValueError("kv_adopt must be the first step of a session")
        spec = step["kv_adopt"]
        src_sid = spec["session_id"]
        cut = int(spec["position"])
        self._prune_migrated()
        self._prune_parked()
        entry = self._migrated.get(src_sid) or self._parked.get(src_sid)
        if entry is None:
            raise KeyError(f"No migrated or parked KV for session {src_sid!r}")
        if not 0 < cut <= entry["position"]:
            raise ValueError(f"kv_adopt position {cut} outside (0, {entry['position']}]")
        if cut > max_length:
            raise ValueError(f"kv_adopt position {cut} exceeds max_length {max_length}")
        if batch_size != entry["batch_size"]:
            raise ValueError(f"kv_adopt batch_size {batch_size} != source {entry['batch_size']}")
        if not (entry["start"] <= abs_start and abs_start + n_blocks <= entry["end"]):
            raise ValueError(
                f"Session blocks [{abs_start}, {abs_start + n_blocks}) outside "
                f"migrated span [{entry['start']}, {entry['end']})"
            )
        b0 = abs_start - entry["start"]
        kv_quant = entry.get("kv_quant") or "none"
        parts = {name: entry[name][b0 : b0 + n_blocks, :, :cut]
                 for name in (("k", "v") if kv_quant == "none" else ("k", "v", "k_scales", "v_scales"))}
        wire_nbytes = int(sum(t.numel() * t.element_size() for t in parts.values()))
        if kv_quant != "none":
            def decode(name):
                return torch.from_numpy(dequantize_kv_np(
                    np.ascontiguousarray(parts[name].numpy()), np.ascontiguousarray(parts[name + "_scales"].numpy()),
                    kv_quant,
                ))

            k, v = await asyncio.to_thread(lambda: (decode("k"), decode("v")))
        else:
            k, v = parts["k"], parts["v"]
        await self._seed_kv(backend, batcher, lane, kv, [k], [v])
        # consumed only now: a failed adopt leaves the entry for a retry or
        # an export until its TTL lapses
        self._consume_migrated(src_sid)
        self._parked.pop(src_sid, None)
        if lane is not None:
            key = batcher._ledger_keys.get(lane)
            if key is not None:
                batcher.ledger.note_migrated(key, wire_nbytes)
        stats = self.migration_stats
        stats["adopts"] += 1
        stats["adopt_bytes"] += wire_nbytes
        stats["adopt_s"] += time.perf_counter() - t0
        get_journal().event(
            "migrate_adopt", trace_id=entry.get("trace_id"), occupancy=self._occupancy(),
            session_id=src_sid, position=cut, nbytes=wire_nbytes,
        )
        return cut

    # ------------------------------------------------------------------ prefix cache

    async def _seed_prefix(self, backend, batcher, lane, kv, keys, entries) -> torch.Tensor:
        """Seed a fresh session's KV rows [0, hit_len) from the cache's
        ``entries`` (resolved on the loop right after the probe), from the
        first tier that holds the whole hit: a paged lane adopts the pinned
        pages of THIS batcher at its current epoch (the block table is the
        seed); else the device tier's copies; else the host tier's rows,
        after which the hit path's hot nodes move up to the device tier off
        the reply path. Returns the cached outputs [1, hit_len, hidden] on
        the host."""
        pc = self.prefix_cache
        outs = [e["out"] for e in entries]
        kd = [e.get("kd") for e in entries]
        vd = [e.get("vd") for e in entries]
        # a lane preempted since its admission (idle with its first page)
        # seeds through run_exclusive instead, which swaps it back in first
        if lane is not None and batcher.page_size is not None and batcher.lane_resident(lane):
            spp = SEGMENT_TOKENS // batcher.page_size
            if all(
                e.get("pages") is not None and e.get("pages_pool") is batcher
                and e.get("pages_epoch") == batcher.page_epoch and len(e["pages"]) == spp
                for e in entries
            ):
                # the refs now belong to the lane's table row: release_lane or
                # a copy-on-write fork drops them
                # swarmlint: disable=paired-refcount — ownership transfer: adopted refs belong to the lane's table row; release_lane / copy-on-write decref them
                batcher.adopt_pages(lane, [p for e in entries for p in e["pages"]])
                pc.stats["page_hits"] = pc.stats.get("page_hits", 0) + 1
                return await asyncio.to_thread(torch.cat, outs, 1)
        if all(x is not None for x in kd) and _device_tier(backend):
            # the whole prefix on the device: no host-to-device transfer
            pc.stats["device_hits"] = pc.stats.get("device_hits", 0) + 1
            prefix_out = await asyncio.to_thread(torch.cat, outs, 1)
            await self._seed_kv(backend, batcher, lane, kv, kd, vd)
            return prefix_out
        k, v, prefix_out = await asyncio.to_thread(pc.concat_entries, entries)
        await self._seed_kv(backend, batcher, lane, kv, [k], [v])
        if pc.device_max_bytes > 0 and _device_tier(backend):
            promo = asyncio.create_task(asyncio.to_thread(pc.maybe_promote_device, keys, len(entries)))
            self._promotions.add(promo)
            promo.add_done_callback(self._promotions.discard)
            promo.add_done_callback(_log_failure("prefix device promotion"))
        return prefix_out

    async def _seed_kv(self, backend, batcher, lane, kv, k_parts, v_parts) -> None:
        """Write the prefix rows (the token-axis concatenation of
        ``k_parts`` / ``v_parts``, on the host or the device) into the
        session's lane or private cache IN PLACE, rows past them zeroed, as
        one task on the compute thread: the prefix cache's hits, a
        ``kv_import`` and a ``kv_adopt``. A paged lane first owns pages for
        the rows (a quantized pool re-encodes them on check-in); the pool
        tensors and the table stay where the step programs read them."""
        n = sum(p.shape[2] for p in k_parts)

        def seed(target):
            backend.seed_cache(target, torch.cat(k_parts, dim=2), torch.cat(v_parts, dim=2))
            return None, target

        if lane is not None and batcher.page_size is not None:
            # the lane is rebuilt whole in the compute type and scattered, as
            # petals_tpu's seed builds it: a quantized pool then encodes the
            # rows as they came, never their bfloat16 decoded view
            def rebuild(_):
                shape = (k_parts[0].shape[0], 1, batcher.max_pages * batcher.page_size, *k_parts[0].shape[3:])
                return seed(tuple(torch.zeros(shape, dtype=backend.compute_dtype, device=backend.device)
                                  for _ in range(2)))

            await batcher.run_exclusive(lane, rebuild, size=n, write_range=(0, n), extract=False)
        elif lane is not None:
            await batcher.run_exclusive(lane, seed, size=n, write_range=(0, n))
        else:
            await self.queue.submit(seed, kv, priority=PRIORITY_INFERENCE, size=n)

    def _maybe_store(self, backend, batcher, lane, kv, keys, n_hit: int, out, n_blocks: int, peer: Optional[str]):
        """Start the store of this prefill's new segments as a task, unless
        it would add nothing (every key present and no tier to gain: device
        copies where the session can give them, live page pins where it
        runs on a paged lane)."""
        pc = self.prefix_cache
        # a segment's host bytes: its k/v rows in the cache's type, and its
        # outputs in the reply's type
        seg_bytes = (
            2 * n_blocks * SEGMENT_TOKENS * backend.num_kv_heads * backend.head_dim * backend.compute_dtype.itemsize
            + SEGMENT_TOKENS * backend.hidden_size * out.element_size()
        )
        paged = lane is not None and batcher.page_size is not None
        device_capable = pc.device_max_bytes > 0 and not paged and _device_tier(backend)
        if not pc.worth_storing(keys, n_hit, seg_bytes, device_capable=device_capable,
                                pages_pool=batcher if paged else None):
            return None
        task = asyncio.create_task(self._store_prefix_async(
            keys, n_hit, len(keys) * SEGMENT_TOKENS, batcher, lane, kv, out, n_blocks, peer,
            device=_device_tier(backend),
        ))
        task.add_done_callback(_log_failure("prefix store"))
        return task

    async def _store_prefix_async(self, keys, n_hit: int, boundary: int, batcher, lane, kv, out_full,
                                  n_blocks: int, peer: Optional[str] = None, device: bool = True) -> None:
        """Snapshot KV rows [0, boundary) and store the fresh segments. Runs
        as a task after the prefill's reply; the session awaits it before
        its next step, so the stored rows match the content hash. A paged
        lane pins the fresh segments' pages; a dense lane's or a private
        cache's rows are also copied to the device tier. A lane preempted
        since its prefill is read from its swap entry (nothing pins then:
        its pages are gone). ``peer`` is the tenant the segments bill to;
        ``device=False`` (a tensor-parallel span) keeps host copies only."""
        pc = self.prefix_cache
        first = n_hit * SEGMENT_TOKENS
        pages, epoch = None, 0
        try:
            if lane is not None:
                if batcher.page_size is not None:
                    # whole stored segments pin: both bounds page-aligned
                    # because page_size divides SEGMENT_TOKENS
                    seg_end = (boundary // SEGMENT_TOKENS) * SEGMENT_TOKENS
                    if seg_end > first:
                        epoch = batcher.page_epoch
                        pages = batcher.pin_lane_pages(lane, first, seg_end)
                return_device = device and pc.device_max_bytes > 0 and batcher.page_size is None
                # a suspended lane: its swap entry holds the rows already
                snap = None if return_device else await batcher.snapshot_from_swap(lane, boundary, 0, n_blocks)
                if snap is None:
                    snap = await batcher.snapshot_lane(lane, boundary, 0, n_blocks, return_device=return_device)
            else:
                def read():
                    if getattr(self.backend, "is_lockstep", False):  # host copies only, through the export
                        return self.backend.export_kv(kv, 0, n_blocks, boundary)
                    k, v = (t[:, :, :boundary] for t in kv)
                    host = (k.cpu(), v.cpu())
                    if pc.device_max_bytes <= 0 or not device:
                        return host
                    return (*host, k[:, :, first:].clone(), v[:, :, first:].clone())

                snap = await self.queue.submit(read, priority=PRIORITY_INFERENCE, size=0)
        except BaseException as e:
            # release the pins on EVERY abnormal exit, a cancellation included:
            # this coroutine awaits between the pin and the cache's commit
            if pages:
                batcher.unpin_pages(pages, epoch)
            if not isinstance(e, Exception):
                raise
            logger.debug(f"Prefix store skipped: {e!r}")  # storing is best-effort
            return
        k, v = snap[:2]
        k_dev = v_dev = None
        if len(snap) == 4:
            k_dev, v_dev = snap[2:]
            if lane is not None:  # the lane's snapshot starts at row 0
                k_dev, v_dev = k_dev[:, :, first:], v_dev[:, :, first:]
        pc.put(
            keys, n_hit, k[:, :, first:], v[:, :, first:], out_full[:, first:boundary],
            k_dev=k_dev, v_dev=v_dev, pages=pages, pages_pool=batcher if pages else None, pages_epoch=epoch,
            tenant=peer,
        )

    def _gen_request(self, step: dict, span: Tuple[int, int], batch_size: int, prompts, hypo_ids,
                     position: int, max_length: int) -> Tuple[int, Optional[dict]]:
        """(tokens to generate, validated sampling dict) of a step, (0, None)
        when it asks for none. The count is clamped to a power of two up to
        ``MAX_GEN_TOKENS`` (the client loops on the count it gets back);
        ``position`` is where the step's own tokens end. Raises, before the
        step runs, for what this server or session cannot generate."""
        gen_n = step.get("gen_tokens")
        if not gen_n:
            return 0, None
        gen_n = max(1, min(int(gen_n), MAX_GEN_TOKENS))
        gen_n = 1 << (gen_n.bit_length() - 1)
        sampling = validate_gen_sampling(step.get("gen_sampling"))
        whole = span == (0, self.backend.n_blocks)
        if not (self.server_gen_params is not None and whole and batch_size == 1
                and prompts is None and hypo_ids is None):
            raise ValueError(
                "server-side generation is not available for this "
                "session (requires a whole-model session on a "
                "full-span single-host server with client "
                "leaves loaded; check the server_gen info flag)"
            )
        if position + gen_n - 1 > max_length:
            raise ValueError(f"Generating {gen_n} tokens at position {position} exceeds max_length {max_length}")
        return gen_n, sampling

    async def _generate(self, backend, batcher, lane, kv, last_hidden, position: int, gen_n: int, sampling,
                        active_adapter=None):
        """``gen_n`` tokens from ``last_hidden`` [1, 1, hidden]: a pooled
        session's through the batcher's generation steps, a private one's
        (an adapter session's among them) through ``generate_tokens`` on the
        task queue. Returns (tokens [1, gen_n], the batcher's queue/compute
        split or None)."""
        if lane is not None:
            tokens = await batcher.generate_lane(lane, last_hidden, position, gen_n, sampling=sampling)
            return tokens, batcher.pop_step_timing(lane)

        def run_gen():
            tokens, _ = backend.generate_tokens(self.server_gen_params, last_hidden, kv, position, gen_n,
                                                sampling=sampling, active_adapter=active_adapter)
            return tokens

        return await self.queue.submit(run_gen, priority=PRIORITY_INFERENCE, size=gen_n), None

    @contextlib.asynccontextmanager
    async def _private_cache_ctx(self, backend, batch_size: int, max_length: int, timeout):
        """A private session's dense cache, budgeted through the memory
        cache; the step programs that address it are dropped before it is
        freed (a graph never outlives the memory it writes)."""
        descriptors = backend.cache_descriptors(batch_size, max_length, 0, backend.n_blocks)
        async with self.memory_cache.allocate_cache(*descriptors, timeout=timeout) as handles:
            try:
                yield handles
            finally:
                backend.drop_cache_programs(self.memory_cache.get_buffers(*handles))

    @staticmethod
    @contextlib.asynccontextmanager
    async def _lane_ctx(lane: int, batcher):
        """A pooled session's stand-in for the cache allocation: no handles,
        and the lane goes back to the pool it was acquired from."""
        try:
            yield ()
        finally:
            batcher.release_lane(lane)

    async def _run_step(self, backend, batcher, lane, kv, hidden, position: int, prompts, hypo_ids,
                        active_adapter=None):
        """One step on the path its session and shape select; returns (out
        on the host, the step_meta variant, the batcher's queue/compute split
        or None, the step program's fused fingerprint of the last row or
        None)."""
        batch_size, seq = hidden.shape[0], hidden.shape[1]
        plain = prompts is None and hypo_ids is None
        if lane is not None and seq == 1 and plain:
            # the continuous-batching hot path: one token, coalesced with
            # whatever other sessions are stepping right now
            t_tok = time.perf_counter()
            out = await batcher.step(lane, hidden, position)
            tm.TOKEN_LATENCY.observe(time.perf_counter() - t_tok)
            return out, "decode", batcher.pop_step_timing(lane), batcher.pop_step_fp(lane)
        if lane is not None and plain and batcher.page_size is not None:
            # paged-lane prefill: one chunk rides each mixed step
            out = await batcher.prefill_lane(lane, hidden, position)
            return out, "prefill", batcher.pop_step_timing(lane), batcher.pop_step_fp(lane)
        if lane is not None and plain:
            # prefill on the DENSE pool: each chunk is its own queue task,
            # so other sessions' batched decode steps interleave between them
            n_total = position + seq
            chunk_fns, off = [], 0
            for clen in backend.chunk_plan(batch_size, seq):
                def run_chunk(kv_lane, chunk=hidden[:, off : off + clen], chunk_pos=position + off):
                    out, kv_lane = backend.inference_step(chunk, kv_lane, chunk_pos, n_total=n_total)
                    return out.cpu(), kv_lane

                chunk_fns.append(run_chunk)
                off += clen
            outs = await batcher.run_exclusive_chunks(
                lane, chunk_fns, size=batch_size * seq, write_range=(position, position + seq)
            )
            return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), "dense_prefill", None, None
        if lane is not None:
            # a pooled session with deep prompts or hypo_ids: one atomic
            # exclusive pass on the lane
            def run_lane(kv_lane):
                out, kv_lane = backend.inference_step(
                    hidden, kv_lane, position, prompts=prompts, hypo_ids=hypo_ids
                )
                return out.cpu(), kv_lane

            out = await batcher.run_exclusive(
                lane, run_lane, size=batch_size * seq, write_range=(position, position + seq)
            )
            return out, "exclusive", None, None

        def run_step():
            out, _ = backend.inference_step(hidden, kv, position, prompts=prompts, hypo_ids=hypo_ids,
                                            active_adapter=active_adapter)
            return out.cpu()  # waits for the step to finish on the device

        out = await self.queue.submit(run_step, priority=PRIORITY_INFERENCE, size=batch_size * seq)
        return out, "private", None, None


def _device_tier(backend) -> bool:
    """Whether the prefix cache may keep device copies for ``backend``'s
    sessions: not under a mesh, whose caches are split over the shards and
    replicated over the sp ranks (the JAX package stores host-only entries
    under a mesh)."""
    return getattr(backend, "mesh_size", 1) == 1


def _log_failure(what: str):
    """A done-callback that logs a background task's failure."""
    return log_exception_callback(logger, what)
