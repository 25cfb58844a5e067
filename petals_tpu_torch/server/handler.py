"""RPC surface of a port server: ``ptu.inference`` sessions and ``ptu.info``
(the subset of petals_tpu/server/handler.py this port serves). The frames and
tensor encodings are those of a petals_tpu server, so petals_tpu clients
drive it unchanged.

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
own. A client id proven by the RPC handshake is ``ctx.remote_peer_id``.

Refused with a clear error: adapters, KV import/adopt, push_to in a step.
A ``push_to`` in the open message (petals_tpu servers push each step's
output to the next server as well) is ignored: the client relays every
step itself, and its copy is the one that counts.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import re
import time
import uuid
from typing import Callable, Optional, Tuple

import torch

from petals_tpu_torch.data_structures import CHAIN_DELIMITER, parse_session_priority, parse_uid
from petals_tpu_torch.rpc.protocol import validate_gen_sampling
from petals_tpu_torch.rpc.serialization import CompressionType, deserialize_array, is_dummy, serialize_array
from petals_tpu_torch.rpc.server import RpcContext, RpcServer
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.memory_cache import AllocationFailed
from petals_tpu_torch.server.prefix_cache import SEGMENT_TOKENS, PrefixCache, segment_keys
from petals_tpu_torch.server.task_queue import PRIORITY_INFERENCE
from petals_tpu_torch.utils.version import incompatibility_error, is_compatible

logger = logging.getLogger(__name__)

_TRACE_ID_RE = re.compile(r"^[0-9A-Za-z_-]{1,64}$")
MAX_GEN_TOKENS = 32  # the longest chunk a generating step answers


def normalize_trace_id(value) -> Optional[str]:
    """A remote-supplied trace id if it is a short url-safe token, else None
    (the server then mints its own)."""
    if not isinstance(value, str) or not _TRACE_ID_RE.match(value):
        return None
    return value


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class TransformerHandler:
    def __init__(
        self,
        backend,
        batcher,
        *,
        dht_prefix: str,
        compression: CompressionType = CompressionType.NONE,
        inference_max_length: Optional[int] = None,
        session_timeout: float = 30 * 60,
        step_timeout: float = 5 * 60,
        server_info_fn: Optional[Callable[[], dict]] = None,  # the announced ServerInfo's fields
        server_gen_params: Optional[dict] = None,  # the client's leaves: server-side generation
        prefix_cache_bytes: int = 256 * 2**20,  # host tier of the prefix cache; 0 disables it
        prefix_share_scope: str = "swarm",  # "swarm" shares across clients; "peer" salts per client
        prefix_device_bytes: int = 256 * 2**20,  # its HBM tier; 0 disables
        prefix_cache_policy: str = "radix",  # "radix" tree | "lru" flat baseline
    ):
        if prefix_share_scope not in ("swarm", "peer"):
            raise ValueError(f"prefix_share_scope must be 'swarm' or 'peer', got {prefix_share_scope!r}")
        self.backend = backend
        self.server_gen_params = server_gen_params
        self.server_info_fn = server_info_fn
        self.batcher = batcher
        # private sessions share the batcher's budget and compute thread
        self.memory_cache = batcher.memory_cache
        self.queue = batcher.queue
        self._sub_backends = {}
        self.dht_prefix = dht_prefix
        self.compression = CompressionType(compression)
        self.inference_max_length = inference_max_length
        self.session_timeout = session_timeout
        self.step_timeout = step_timeout
        self.prefix_share_scope = prefix_share_scope
        self.prefix_cache = None
        if prefix_cache_bytes > 0:
            self.prefix_cache = PrefixCache(
                prefix_cache_bytes, device_max_bytes=prefix_device_bytes, policy=prefix_cache_policy,
                device=backend.device,
            )
            # a pinned page run is sliced at segment boundaries, so segments
            # must tile exactly into pages
            if batcher.page_size is not None and SEGMENT_TOKENS % batcher.page_size:
                raise ValueError(
                    f"page_size={batcher.page_size} must divide the prefix-cache segment size "
                    f"({SEGMENT_TOKENS} tokens)"
                )
        self._promotions: set = set()  # in-flight device-tier promotions (strong refs)

    def register(self, server: RpcServer) -> None:
        server.add_unary_handler("ptu.info", self.rpc_info)
        server.add_stream_handler("ptu.inference", self.rpc_inference)

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
        no copy), cached per (start, end)."""
        if start == 0 and end == self.backend.n_blocks:
            return self.backend
        key = (start, end)
        if key not in self._sub_backends:
            b = self.backend
            self._sub_backends[key] = TransformerBackend(
                b.family, b.cfg, b._slice_params(start, end),
                first_block=b.first_block + start, n_blocks=end - start, device=b.device,
                compute_dtype=b.compute_dtype, max_chunk_size_bytes=b.max_chunk_size_bytes,
                quant_type=b.quant_type, use_flash=b.use_flash,
            )
        return self._sub_backends[key]

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
            raise ValueError(f"Compression {requested!r} is not supported by this server yet") from None

    async def rpc_info(self, payload, ctx: RpcContext):
        b = self.batcher
        info = dict(self.server_info_fn()) if self.server_info_fn is not None else {}
        info |= {
            "first_block": self.backend.first_block,
            "n_blocks": self.backend.n_blocks,
            "dht_prefix": self.dht_prefix,
            "inference_max_length": self.inference_max_length,
            "quant_type": self.backend.quant_type,  # petals_tpu's ServerInfo.quant_type
            "kv_quant": self.backend.kv_quant_type,
            # free bytes over the LOGICAL (floating-point) bytes a token, as
            # petals_tpu's rpc_info answers; the announce's cache_tokens_left
            # counts stored bytes (server.py)
            "cache_tokens_available": max(
                b.memory_cache.bytes_left // max(self.backend.cache_bytes_per_token(), 1), 0
            ),
            "continuous_batching": {
                "lanes": b.n_lanes,
                "max_length": b.max_length,
                "page_size": b.page_size,
                "n_pages": b.n_pages,
                "prefill_token_budget": b.prefill_token_budget,
                **b.pool_info(),
                **b.stats,
            },
        }
        paged = b.paged_summary()
        if paged is not None:
            info["continuous_batching"]["paged"] = paged
        if self.prefix_cache is not None:
            info["prefix_cache"] = self.prefix_cache.summary()
        return info

    async def rpc_inference(self, requests, ctx: RpcContext):
        """Bidirectional inference stream: open -> step* -> end."""
        open_msg = await asyncio.wait_for(anext(requests), self.step_timeout)
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
        if open_msg.get("active_adapter") is not None:
            raise ValueError("adapters are not supported by this server yet")
        trace_id = normalize_trace_id(open_msg.get("trace_id")) or new_trace_id()
        backend = self._sub_backend(start, end)
        batcher = self.batcher
        alloc_timeout = open_msg.get("alloc_timeout")
        lane: Optional[int] = None
        t_open = time.perf_counter()
        if batch_size == 1 and (start, end) == (0, self.backend.n_blocks) and max_length <= batcher.max_length:
            try:
                lane = await batcher.acquire_lane(
                    timeout=30.0 if alloc_timeout is None else alloc_timeout,
                    priority=parse_session_priority(open_msg.get("priority")),
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
            yield {
                "session_open": True, "position": 0, "max_length": max_length,
                "trace_id": trace_id, "open_wait_s": round(open_wait_s, 6),
            }
            position = 0
            pending_store = None  # the in-flight prefix-cache store
            try:
                while True:
                    try:
                        step = await asyncio.wait_for(anext(requests), self.session_timeout)
                    except StopAsyncIteration:
                        step = None  # the client half-closed
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
                    position, reply, pending_store = await self._serve_step(
                        step, t_recv, ctx, backend, batcher, lane, kv, (start, end), batch_size, max_length,
                        position, reply_comp,
                    )
                    yield reply
            finally:
                if pending_store is not None:
                    # a failure or a cancellation: the store is dropped now,
                    # and releases its pins on the way out
                    pending_store.cancel()

    async def _serve_step(self, step, t_recv, ctx, backend, batcher, lane, kv, span, batch_size, max_length,
                          position, reply_comp):
        """One step of a session: returns (the new position, the reply, the
        prefix store it started or None)."""
        start, end = span
        for key in ("kv_adopt", "kv_import", "push_to"):
            if step.get(key):
                raise ValueError(f"step field {key!r} is not supported by this server yet")
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
            and hypo_ids is None and seq >= SEGMENT_TOKENS
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
                prefix_out = await self._seed_prefix(backend, batcher, lane, kv, keys, entries)
        hit_len = n_hit * SEGMENT_TOKENS
        if hit_len == seq:
            # the whole prefill was cached: nothing runs on the device
            out, variant, timing = prefix_out, "cached", None
        else:
            out, variant, timing = await asyncio.wait_for(
                self._run_step(backend, batcher, lane, kv, hidden[:, hit_len:], position + hit_len, prompts,
                               hypo_ids),
                self.step_timeout,
            )
            if prefix_out is not None:  # the cached outputs ahead of the tail's
                out = torch.cat([prefix_out.to(out.dtype), out], dim=1)
        if timing is None:  # not a coalesced step: the execution wall, queue included
            timing = {"queue_s": 0.0, "compute_s": time.perf_counter() - t_exec}
        pending_store = None
        if keys is not None and len(keys) > n_hit:
            pending_store = self._maybe_store(backend, batcher, lane, kv, keys, n_hit, out, end - start)
        position += seq
        if gen_n:
            t_gen = time.perf_counter()
            tokens, gen_timing = await asyncio.wait_for(
                self._generate(backend, batcher, lane, kv, out[:, -1:], position, gen_n, gen_sampling),
                self.step_timeout,
            )
            if gen_timing is not None:  # the batcher's steps: the two phases sum
                timing = {"queue_s": timing.get("queue_s", 0.0) + gen_timing["queue_s"],
                          "compute_s": timing.get("compute_s", 0.0) + gen_timing["compute_s"]}
                variant += "+gen"
            else:
                timing = {**timing, "compute_s": timing.get("compute_s", 0.0) + time.perf_counter() - t_gen}
            position += gen_n - 1  # the last token is never fed
            step_meta = {
                "queue_s": round(timing["queue_s"], 6), "compute_s": round(timing["compute_s"], 6),
                "variant": variant, "serialize_s": 0.0, "total_s": round(time.perf_counter() - t_recv, 6),
            }
            return position, {"tokens": [int(t) for t in tokens[0]], "position": position,
                              "step_meta": step_meta}, pending_store
        t_ser = time.perf_counter()
        wire_out = serialize_array(out, reply_comp)
        step_meta = {
            "queue_s": round(timing.get("queue_s", 0.0), 6),
            "compute_s": round(timing.get("compute_s", 0.0), 6),
            "variant": variant,
            "serialize_s": round(time.perf_counter() - t_ser, 6),
            "total_s": round(time.perf_counter() - t_recv, 6),
        }
        return position, {"tensors": {"hidden": wire_out}, "position": position, "step_meta": step_meta}, pending_store

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
        if lane is not None and batcher.page_size is not None:
            spp = SEGMENT_TOKENS // batcher.page_size
            if all(
                e.get("pages") is not None and e.get("pages_pool") is batcher
                and e.get("pages_epoch") == batcher.page_epoch and len(e["pages"]) == spp
                for e in entries
            ):
                # the refs now belong to the lane's table row: release_lane or
                # a copy-on-write fork drops them
                batcher.adopt_pages(lane, [p for e in entries for p in e["pages"]])
                pc.stats["page_hits"] = pc.stats.get("page_hits", 0) + 1
                return await asyncio.to_thread(torch.cat, outs, 1)
        if all(x is not None for x in kd):
            # the whole prefix on the device: no host-to-device transfer
            pc.stats["device_hits"] = pc.stats.get("device_hits", 0) + 1
            prefix_out = await asyncio.to_thread(torch.cat, outs, 1)
            await self._seed_kv(backend, batcher, lane, kv, kd, vd)
            return prefix_out
        k, v, prefix_out = await asyncio.to_thread(pc.concat_entries, entries)
        await self._seed_kv(backend, batcher, lane, kv, [k], [v])
        if pc.device_max_bytes > 0:
            promo = asyncio.create_task(asyncio.to_thread(pc.maybe_promote_device, keys, len(entries)))
            self._promotions.add(promo)
            promo.add_done_callback(self._promotions.discard)
            promo.add_done_callback(_log_failure("prefix device promotion"))
        return prefix_out

    async def _seed_kv(self, backend, batcher, lane, kv, k_parts, v_parts) -> None:
        """Write the prefix rows (the token-axis concatenation of
        ``k_parts`` / ``v_parts``, on the host or the device) into the
        session's lane or private cache IN PLACE, rows past them zeroed, as
        one task on the compute thread. A paged lane first owns pages for
        the rows (a quantized pool re-encodes them on check-in)."""
        n = sum(p.shape[2] for p in k_parts)

        def seed(target):
            backend.seed_cache(target, torch.cat(k_parts, dim=2), torch.cat(v_parts, dim=2))
            return None, target

        if lane is not None:
            await batcher.run_exclusive(lane, seed, size=n, write_range=(0, n))
        else:
            await self.queue.submit(seed, kv, priority=PRIORITY_INFERENCE, size=n)

    def _maybe_store(self, backend, batcher, lane, kv, keys, n_hit: int, out, n_blocks: int):
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
        if not pc.worth_storing(keys, n_hit, seg_bytes, device_capable=pc.device_max_bytes > 0 and not paged,
                                pages_pool=batcher if paged else None):
            return None
        task = asyncio.create_task(self._store_prefix_async(
            keys, n_hit, len(keys) * SEGMENT_TOKENS, batcher, lane, kv, out, n_blocks,
        ))
        task.add_done_callback(_log_failure("prefix store"))
        return task

    async def _store_prefix_async(self, keys, n_hit: int, boundary: int, batcher, lane, kv, out_full,
                                  n_blocks: int) -> None:
        """Snapshot KV rows [0, boundary) and store the fresh segments. Runs
        as a task after the prefill's reply; the session awaits it before
        its next step, so the stored rows match the content hash. A paged
        lane pins the fresh segments' pages; a dense lane's or a private
        cache's rows are also copied to the device tier."""
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
                snap = await batcher.snapshot_lane(
                    lane, boundary, 0, n_blocks, return_device=pc.device_max_bytes > 0 and batcher.page_size is None
                )
            else:
                def read():
                    k, v = (t[:, :, :boundary] for t in kv)
                    host = (k.cpu(), v.cpu())
                    if pc.device_max_bytes <= 0:
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

    async def _generate(self, backend, batcher, lane, kv, last_hidden, position: int, gen_n: int, sampling):
        """``gen_n`` tokens from ``last_hidden`` [1, 1, hidden]: a pooled
        session's through the batcher's generation steps, a private one's
        through ``generate_tokens`` on the task queue. Returns (tokens [1,
        gen_n], the batcher's queue/compute split or None)."""
        if lane is not None:
            tokens = await batcher.generate_lane(lane, last_hidden, position, gen_n, sampling=sampling)
            return tokens, batcher.pop_step_timing(lane)

        def run_gen():
            tokens, _ = backend.generate_tokens(self.server_gen_params, last_hidden, kv, position, gen_n,
                                                sampling=sampling)
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

    async def _run_step(self, backend, batcher, lane, kv, hidden, position: int, prompts, hypo_ids):
        """One step on the path its session and shape select; returns (out
        on the host, the step_meta variant, the batcher's queue/compute split
        or None)."""
        batch_size, seq = hidden.shape[0], hidden.shape[1]
        plain = prompts is None and hypo_ids is None
        if lane is not None and seq == 1 and plain:
            # the continuous-batching hot path: one token, coalesced with
            # whatever other sessions are stepping right now
            out = await batcher.step(lane, hidden, position)
            return out, "decode", batcher.pop_step_timing(lane)
        if lane is not None and plain and batcher.page_size is not None:
            # paged-lane prefill: one chunk rides each mixed step
            out = await batcher.prefill_lane(lane, hidden, position)
            return out, "prefill", batcher.pop_step_timing(lane)
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
            return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), "dense_prefill", None
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
            return out, "exclusive", None

        def run_step():
            out, _ = backend.inference_step(hidden, kv, position, prompts=prompts, hypo_ids=hypo_ids)
            return out.cpu()  # waits for the step to finish on the device

        out = await self.queue.submit(run_step, priority=PRIORITY_INFERENCE, size=batch_size * seq)
        return out, "private", None


def _log_failure(what: str):
    """A done-callback that logs a background task's failure."""

    def callback(task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            logger.warning(f"{what} failed", exc_info=task.exception())

    return callback
