"""The port's server entry point: host a span of blocks of one local
checkpoint and answer ``ptu.inference`` / ``ptu.info`` on ``host:port``
(petals_tpu/server/server.py without the DHT, announcements, auto-placement
and throughput probing).

Runs on the CUDA card unless the caller passes ``device="cpu"``; a missing
card raises instead of drifting to the CPU.
"""

from __future__ import annotations

import asyncio
import logging
import re
from typing import Optional

import torch

from petals_tpu_torch.ops.paged_flash_attention import kernel_library
from petals_tpu_torch.rpc.serialization import CompressionType
from petals_tpu_torch.rpc.server import RpcServer
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.server.handler import TransformerHandler
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
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
        page_size: int = 64,
        n_pages: Optional[int] = None,
        prefill_token_budget: int = 512,
    ):
        self.device = resolve_device(device)
        self.model_path = model_path
        self.family, self.cfg = get_block_config(model_path)
        total = self.cfg.num_hidden_layers
        if not 0 <= first_block < first_block + num_blocks <= total:
            raise ValueError(f"span [{first_block}, {first_block + num_blocks}) outside the model's {total} blocks")
        if page_size < 1:
            raise ValueError("this server serves the paged KV pool only: page_size must be >= 1")
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
        params = [
            load_block_params(
                model_path, i, dtype=compute_dtype, device=self.device, family=self.family, cfg=self.cfg
            )
            for i in range(first_block, first_block + num_blocks)
        ]
        self.backend = TransformerBackend(
            self.family, self.cfg, params,
            first_block=first_block, n_blocks=num_blocks,
            device=self.device, compute_dtype=compute_dtype,
            max_chunk_size_bytes=max_chunk_size_bytes,
        )
        batch_max_length = batch_max_length or min(inference_max_length, 1024)
        if batch_lanes is None:
            # lanes cost their full length in pages: cap the pool at half the
            # cache budget, as petals_tpu does
            lane_bytes = self.backend.cache_bytes_per_token() * batch_max_length
            batch_lanes = min(8, int(self.memory_cache.max_size_bytes // 2 // max(lane_bytes, 1)))
        if batch_lanes < 1:
            raise ValueError(
                f"the cache budget of {attn_cache_bytes} bytes affords no lane of "
                f"{batch_max_length} tokens"
            )
        self.queue = PriorityTaskQueue()
        self.batcher = DecodeBatcher(
            self.backend, self.memory_cache, self.queue,
            n_lanes=batch_lanes, max_length=batch_max_length, page_size=page_size,
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
            await asyncio.to_thread(kernel_library)
        self.queue.start()
        self.rpc_server = RpcServer(self.host, self.port)
        self.handler.register(self.rpc_server)
        await self.rpc_server.start()
        logger.info(
            f"Serving blocks [{self.first_block}, {self.first_block + self.num_blocks}) of "
            f"{self.model_path} on {self.host}:{self.rpc_server.port} ({self.device})"
        )

    async def shutdown(self) -> None:
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        await self.batcher.close()
        self.queue.shutdown()
