"""RPC surface of a port server: ``ptu.inference`` sessions on the paged
lane pool and ``ptu.info`` (the subset of petals_tpu/server/handler.py this
slice serves). The frames and tensor encodings are those of a petals_tpu
server, so petals_tpu clients drive it unchanged.

A session is served when it fits the lane pool: batch size 1, the whole
span, ``max_length`` within the lane length, no adapter. Its steps carry
hidden states only. Anything else (private caches, deep prompts, hypo_ids,
KV import/adopt, server-side generation) is refused with a clear error.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional, Tuple

import torch

from petals_tpu_torch.data_structures import CHAIN_DELIMITER, parse_session_priority, parse_uid
from petals_tpu_torch.rpc.serialization import CompressionType, deserialize_array, is_dummy, serialize_array
from petals_tpu_torch.rpc.server import RpcContext, RpcServer

logger = logging.getLogger(__name__)


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
    ):
        self.backend = backend
        self.batcher = batcher
        self.dht_prefix = dht_prefix
        self.compression = CompressionType(compression)
        self.inference_max_length = inference_max_length
        self.session_timeout = session_timeout
        self.step_timeout = step_timeout

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
        return {
            "first_block": self.backend.first_block,
            "n_blocks": self.backend.n_blocks,
            "dht_prefix": self.dht_prefix,
            "inference_max_length": self.inference_max_length,
            "quant_type": self.backend.quant_type,  # petals_tpu's ServerInfo.quant_type
            "kv_quant": self.backend.kv_quant_type,
            # a cached token costs its stored bytes (petals_tpu's
            # ServerInfo.cache_tokens_left)
            "cache_tokens_available": max(
                b.memory_cache.bytes_left // max(self.backend.kv_bytes_per_token(), 1), 0
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

    async def rpc_inference(self, requests, ctx: RpcContext):
        """Bidirectional inference stream: open -> step* -> end."""
        open_msg = await asyncio.wait_for(anext(requests), self.step_timeout)
        start, end = self._parse_chain(open_msg["uids"])
        max_length = int(open_msg["max_length"])
        if self.inference_max_length is not None and max_length > self.inference_max_length:
            raise ValueError(
                f"max_length {max_length} exceeds this server's inference_max_length "
                f"{self.inference_max_length}"
            )
        batch_size = int(open_msg.get("batch_size", 1))
        reply_comp = self._reply_compression(open_msg)
        batcher = self.batcher
        if (
            batch_size != 1
            or open_msg.get("active_adapter") is not None
            or (start, end) != (0, self.backend.n_blocks)
            or max_length > batcher.max_length
        ):
            raise ValueError(
                "this server serves sessions of batch size 1 over its whole span "
                f"[{self.backend.first_block}, {self.backend.first_block + self.backend.n_blocks}) "
                f"with max_length <= {batcher.max_length} and no adapter; other sessions "
                "(private caches, sub-spans, adapters) are not supported by this server yet"
            )
        alloc_timeout = open_msg.get("alloc_timeout")
        t_open = time.perf_counter()
        lane = await batcher.acquire_lane(
            timeout=30.0 if alloc_timeout is None else alloc_timeout,
            priority=parse_session_priority(open_msg.get("priority")),
        )
        try:
            yield {
                "session_open": True, "position": 0, "max_length": max_length,
                "open_wait_s": round(time.perf_counter() - t_open, 6),
            }
            position = 0
            while True:
                try:
                    step = await asyncio.wait_for(anext(requests), self.session_timeout)
                except StopAsyncIteration:
                    break  # the client half-closed
                t_recv = time.perf_counter()
                for key in ("kv_adopt", "kv_import", "gen_tokens", "gen_sampling", "push_to"):
                    if step.get(key):
                        raise ValueError(f"step field {key!r} is not supported by this server yet")
                start_from = step.get("start_from_position")
                if start_from is not None:
                    if not 0 <= int(start_from) <= position:
                        raise ValueError(
                            f"start_from_position {start_from} is outside the cache [0, {position}]"
                        )
                    position = int(start_from)  # rollback: later rows are overwritten
                if self._get_tensor(step, "prompts") is not None or self._get_tensor(step, "hypo_ids") is not None:
                    raise ValueError("deep prompts and hypo_ids are not supported by this server yet")
                hidden = self._get_tensor(step, "hidden")
                if hidden is None or hidden.shape[1] == 0:
                    yield {"tensors": {}, "position": position}  # cache probe
                    continue
                hsz = self.backend.hidden_size
                if hidden.dim() != 3 or hidden.shape[0] != 1 or hidden.shape[2] != hsz:
                    raise ValueError(
                        f"step hidden must be [batch=1, seq, hidden={hsz}], got {tuple(hidden.shape)}"
                    )
                seq = hidden.shape[1]
                if position + seq > max_length:
                    raise ValueError(
                        f"Step of {seq} tokens at position {position} exceeds max_length {max_length}"
                    )
                if seq == 1:
                    out = await asyncio.wait_for(batcher.step(lane, hidden, position), self.step_timeout)
                else:
                    out = await asyncio.wait_for(
                        batcher.prefill_lane(lane, hidden, position), self.step_timeout
                    )
                position += seq
                timing = batcher.pop_step_timing(lane) or {}
                t_ser = time.perf_counter()
                wire_out = serialize_array(out, reply_comp)
                step_meta = {
                    "queue_s": round(timing.get("queue_s", 0.0), 6),
                    "compute_s": round(timing.get("compute_s", 0.0), 6),
                    "variant": timing.get("variant", "decode" if seq == 1 else "prefill"),
                    "serialize_s": round(time.perf_counter() - t_ser, 6),
                    "total_s": round(time.perf_counter() - t_recv, 6),
                }
                yield {"tensors": {"hidden": wire_out}, "position": position, "step_meta": step_meta}
        finally:
            batcher.release_lane(lane)
