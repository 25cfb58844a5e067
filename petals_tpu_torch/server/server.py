"""The port's server entry point: host a span of blocks of one local
checkpoint and answer ``ptu.inference`` / ``ptu.info`` on ``host:port``
(petals_tpu/server/server.py without the DHT, announcements, auto-placement
and throughput probing). ``quant_type`` serves the span with quantized
weights: each block is loaded, fused and quantized on the device, one block
at a time (the JAX server's disk cache of quantized blocks is not ported).
``kv_quant_type`` (int8, nf4a) keeps the paged KV pool quantized, which
fits more lanes in the same cache budget; it combines with every
``quant_type``. ``page_size=0`` selects the dense lane pool in place of the
paged one. Sessions that fit no lane (batch > 1, a sub-span, a longer
``max_length``) are served from private dense caches out of the same budget.

Runs on the CUDA card unless the caller passes ``device="cpu"``; a missing
card raises instead of drifting to the CPU.
"""

from __future__ import annotations

import asyncio
import logging
import re
from typing import Optional

import torch

from petals_tpu_torch.ops import flash_attention, paged_flash_attention, quant_matmul
from petals_tpu_torch.ops.paged_attention import KV_QUANT_KINDS
from petals_tpu_torch.rpc.serialization import CompressionType
from petals_tpu_torch.rpc.server import RpcServer
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.server.handler import TransformerHandler
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.utils.convert_block import QuantType, convert_block_params
from petals_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def default_dht_prefix(model_name: str) -> str:
    """The swarm namespace derived from the model name, as petals_tpu
    derives it: the name minus its org, with an '-hf' suffix."""
    name = model_name.rstrip("/").split("/")[-1]
    name = re.sub(r"[^\w.-]", "-", name)
    return f"{name}-hf"


class Server:
    """Hosts blocks [first_block, first_block + num_blocks) of one model."""

    def __init__(
        self,
        model_path: str,
        *,
        first_block: int,
        num_blocks: int,
        dht_prefix: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        device=None,  # None: the current CUDA device
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_cache_bytes: Optional[int] = None,  # None: 15% of the card's memory
        max_chunk_size_bytes: int = 256 * 1024 * 1024,
        max_alloc_timeout: float = 600.0,
        compression: str = "none",
        inference_max_length: Optional[int] = None,  # None: 8192 for GQA/MQA, 2048 otherwise
        session_timeout: float = 30 * 60,
        step_timeout: float = 5 * 60,
        batch_lanes: Optional[int] = None,  # None: auto-size to the cache budget (<=8)
        batch_max_length: Optional[int] = None,  # None: min(inference_max_length, 1024)
        page_size: int = 64,  # paged KV: tokens per page; 0 = the dense lane pool
        n_pages: Optional[int] = None,
        prefill_token_budget: int = 512,
        quant_type: str = "none",  # "none" | "int8" | "nf4" | "nf4a" | "int4" | "nf4a+o" | "int4+o"
        kv_quant_type: str = "none",  # "none" | "int8" | "nf4a"
    ):
        if kv_quant_type not in KV_QUANT_KINDS:
            raise ValueError(f"kv_quant_type must be one of {KV_QUANT_KINDS}, got {kv_quant_type!r}")
        if page_size is None or page_size < 0:
            raise ValueError(f"page_size must be >= 1, or 0 for the dense lane pool; got {page_size}")
        if kv_quant_type != "none" and not page_size:
            raise ValueError(
                "kv_quant_type requires the paged KV pool (--page_size > 0): the "
                "dense lane pool has no quantized storage path"
            )
        self.device = resolve_device(device)
        self.quant_type = QuantType(quant_type).value
        self.kv_quant_type = kv_quant_type
        self.model_path = model_path
        self.family, self.cfg = get_block_config(model_path)
        total = self.cfg.num_hidden_layers
        if not 0 <= first_block < first_block + num_blocks <= total:
            raise ValueError(f"span [{first_block}, {first_block + num_blocks}) outside the model's {total} blocks")
        self.first_block, self.num_blocks = first_block, num_blocks
        self.dht_prefix = dht_prefix or default_dht_prefix(model_path)
        self.host, self.port = host, port
        self.compute_dtype = compute_dtype
        if attn_cache_bytes is None:
            # default KV budget: 15% of device memory, as petals_tpu sizes it
            if self.device.type == "cuda":
                attn_cache_bytes = int(torch.cuda.mem_get_info(self.device)[1] * 0.15)
            else:
                attn_cache_bytes = 2 << 30
        self.memory_cache = MemoryCache(attn_cache_bytes, max_alloc_timeout)
        if inference_max_length is None:
            hq, hkv = self.cfg.num_attention_heads, self.cfg.num_key_value_heads
            inference_max_length = 8192 if hkv < hq else 2048
        self.inference_max_length = inference_max_length
        # one block at a time: its dense weights are freed once quantized
        # (fused qkv / gate+up, as the JAX server fuses on one device)
        params = [
            convert_block_params(
                load_block_params(
                    model_path, i, dtype=compute_dtype, device=self.device, family=self.family, cfg=self.cfg
                ),
                self.family.name, self.quant_type, fuse=True,
            )
            for i in range(first_block, first_block + num_blocks)
        ]
        self.backend = TransformerBackend(
            self.family, self.cfg, params,
            first_block=first_block, n_blocks=num_blocks,
            device=self.device, compute_dtype=compute_dtype,
            max_chunk_size_bytes=max_chunk_size_bytes, quant_type=self.quant_type,
            kv_quant_type=kv_quant_type,
        )
        batch_max_length = batch_max_length or min(inference_max_length, 1024)
        if batch_lanes is None:
            # lanes cost their full length: cap the pool at half the cache
            # budget, as petals_tpu does (the other half serves private
            # sessions); a quantized pool's pages cost their stored bytes
            lane_bytes = self.backend.kv_bytes_per_token() * batch_max_length
            batch_lanes = min(8, int(self.memory_cache.max_size_bytes // 2 // max(lane_bytes, 1)))
        if batch_lanes < 1:
            raise ValueError(
                f"the cache budget of {attn_cache_bytes} bytes affords no lane of "
                f"{batch_max_length} tokens"
            )
        self.queue = PriorityTaskQueue()
        self.batcher = DecodeBatcher(
            self.backend, self.memory_cache, self.queue,
            n_lanes=batch_lanes, max_length=batch_max_length, page_size=page_size or None,
            n_pages=n_pages, prefill_token_budget=prefill_token_budget,
            alloc_timeout=max_alloc_timeout,
        )
        self.handler = TransformerHandler(
            self.backend, self.batcher,
            dht_prefix=self.dht_prefix, compression=CompressionType(compression),
            inference_max_length=inference_max_length,
            session_timeout=session_timeout, step_timeout=step_timeout,
        )
        self.rpc_server: Optional[RpcServer] = None

    async def start(self) -> None:
        if self.device.type == "cuda":
            # build (or load) the CUDA kernels now, not inside the first step
            await asyncio.to_thread(paged_flash_attention.kernel_library)
            await asyncio.to_thread(flash_attention.kernel_library)
            if self.quant_type != QuantType.NONE.value:
                await asyncio.to_thread(quant_matmul.kernel_library)
        self.queue.start()
        self.rpc_server = RpcServer(self.host, self.port)
        self.handler.register(self.rpc_server)
        await self.rpc_server.start()
        logger.info(
            f"Serving blocks [{self.first_block}, {self.first_block + self.num_blocks}) of "
            f"{self.model_path} on {self.host}:{self.rpc_server.port} ({self.device}, quant={self.quant_type}, "
            f"kv_quant={self.kv_quant_type})"
        )

    async def shutdown(self) -> None:
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        await self.batcher.close()
        self.queue.shutdown()
