"""The port's server entry point: host a span of blocks of one local
checkpoint, serve ``ptu.inference`` / ``ptu.info`` on ``host:port``, and take
part in a petals_tpu swarm (petals_tpu/server/server.py without the relay,
the rebalance loop, adapters, drain and migration).

``start()`` runs the swarm life cycle in petals_tpu's order: it makes the
node's identity (``identity_seed``), listens with it, joins the DHT on the
same listener (``initial_peers``; none starts a swarm of one), measures its
throughput when ``throughput="auto"`` (server/throughput.py, on the device
it serves from), places its span where the swarm is weakest when
``first_block`` is None (and sizes it to the card when ``num_blocks`` is
None), announces JOINING, loads the span off the event loop, registers its
methods, announces ONLINE, and then announces again every
``update_period`` with the RTTs of its successors. ``shutdown()`` announces
OFFLINE for 60 seconds. The backend, batcher and handler exist once
``start()`` returns.

``quant_type`` serves the span with quantized weights: each block is
loaded, fused and quantized on the device, one block at a time (the JAX
server's disk cache of quantized blocks is not ported). ``kv_quant_type``
(int8, nf4a) keeps the paged KV pool quantized, which fits more lanes in the
same cache budget; it combines with every ``quant_type``. ``page_size=0``
selects the dense lane pool in place of the paged one. Sessions that fit no
lane (batch > 1, a sub-span, a longer ``max_length``) are served from
private dense caches out of the same budget.

A server that hosts the whole model (``server_side_generation``, the
default) also loads the client's leaves (embeddings, final norm, head) in
float32 and generates tokens in its own step programs for a client that
asks (``gen_tokens``); it announces ``server_gen`` and
``server_gen_sampling`` then, as petals_tpu's does. The leaves lie beside
the weights, outside the KV budget (``attn_cache_bytes``): about 1.05 GB at
Mistral-7B's widths, logged at load.

The prompt-prefix cache (server/prefix_cache.py) is on with petals_tpu's
defaults: a 256 MiB host tier (``prefix_cache_bytes``), a 256 MiB HBM tier
(``prefix_device_bytes``, which an auto-sized KV budget gives up, as
petals_tpu's does), the ``radix`` policy and ``swarm`` sharing; a paged
pool's page size must then divide its 128-token segments.

Runs on the CUDA card unless the caller passes ``device="cpu"``; a missing
card raises instead of drifting to the CPU.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import math
import random
import re
from typing import Optional, Sequence

import numpy as np
import torch

import petals_tpu_torch
from petals_tpu_torch.data_structures import ServerInfo, ServerState
from petals_tpu_torch.dht.identity import Identity
from petals_tpu_torch.dht.node import DHTNode, dht_time
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.ops import flash_attention, paged_flash_attention, quant_matmul
from petals_tpu_torch.ops.paged_attention import KV_QUANT_KINDS
from petals_tpu_torch.rpc.serialization import CompressionType
from petals_tpu_torch.rpc.server import RpcServer
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.block_selection import choose_best_start, compute_throughputs
from petals_tpu_torch.server.block_utils import choose_num_blocks
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.server.handler import TransformerHandler
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.prefix_cache import resolve_device_bytes
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.server.throughput import get_server_throughput
from petals_tpu_torch.utils.bandwidth import probe_swarm_bandwidth_mbps
from petals_tpu_torch.utils.convert_block import QuantType, convert_block_params
from petals_tpu_torch.utils.device import resolve_device
from petals_tpu_torch.utils.dht_utils import (
    declare_active_modules,
    declare_model,
    default_expiration,
    get_remote_module_infos,
    module_uids,
)
from petals_tpu_torch.utils.ping import PingAggregator

logger = logging.getLogger(__name__)

DEFAULT_UPDATE_PERIOD = 30.0
OFFLINE_EXPIRATION = 60.0  # how long the final OFFLINE announce stays readable
MAX_PINGED_SUCCESSORS = 10


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
        first_block: Optional[int] = None,  # None: placed where the swarm is weakest
        num_blocks: Optional[int] = None,  # None: the rest of the model, or what fits the card
        dht_prefix: Optional[str] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        initial_peers: Sequence = (),  # bootstrap peers (host:port/peer_id or PeerAddr)
        identity_seed: Optional[bytes] = None,  # a deterministic peer id
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
        throughput="auto",  # a number, or "auto" to measure it (server/throughput.py)
        public_name: Optional[str] = None,
        update_period: float = DEFAULT_UPDATE_PERIOD,
        network_mbps: Optional[float] = None,  # a known network budget; None: probe the peers
        server_side_generation: bool = True,  # generate on a whole-model span (gen_tokens)
        prefix_cache_bytes: int = 256 * 2**20,  # host tier of the prompt-prefix cache; 0 disables it
        prefix_share_scope: str = "swarm",  # "peer" isolates the prefix cache per client identity
        prefix_device_bytes: int = 256 * 2**20,  # its HBM tier; 0 disables
        prefix_cache_policy: str = "radix",  # "radix" tree | "lru" flat baseline
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
        if not isinstance(throughput, (int, float)) and throughput != "auto":
            raise ValueError(f'throughput must be a number or "auto", got {throughput!r}')
        self.device = resolve_device(device)
        self.quant_type = QuantType(quant_type).value
        self.kv_quant_type = kv_quant_type
        self.model_path = model_path
        self.family, self.cfg = get_block_config(model_path)
        total = self.cfg.num_hidden_layers
        # PETALS_TPU_RADIX_DEVICE_FRAC retunes the prefix cache's HBM/host
        # split as a fraction of prefix_cache_bytes
        prefix_device_bytes = resolve_device_bytes(prefix_cache_bytes, prefix_device_bytes)
        if attn_cache_bytes is None:
            # default KV budget: 15% of device memory, as petals_tpu sizes it
            if self.device.type == "cuda":
                attn_cache_bytes = int(torch.cuda.mem_get_info(self.device)[1] * 0.15)
            else:
                attn_cache_bytes = 2 << 30
            # the prefix cache's HBM tier lives outside the KV budget: carve
            # it out of an auto-sized one, floored so that a large tier cannot
            # starve serving
            if prefix_device_bytes > 0:
                attn_cache_bytes = max(attn_cache_bytes - prefix_device_bytes, attn_cache_bytes // 4)
        if num_blocks is None:
            num_blocks = total - first_block if first_block is not None else choose_num_blocks(
                self.family, self.cfg, quant_type=self.quant_type, attn_cache_bytes=attn_cache_bytes,
                device=self.device,
            )
        if first_block is not None and not 0 <= first_block < first_block + num_blocks <= total:
            raise ValueError(f"span [{first_block}, {first_block + num_blocks}) outside the model's {total} blocks")
        if not 1 <= num_blocks <= total:
            raise ValueError(f"num_blocks={num_blocks} outside [1, {total}]")
        self.first_block, self.num_blocks = first_block, num_blocks
        self.dht_prefix = dht_prefix or default_dht_prefix(model_path)
        self.host, self.port = host, port
        self.initial_peers = list(initial_peers)
        self.identity_seed = identity_seed
        self.compute_dtype = compute_dtype
        self.max_chunk_size_bytes = max_chunk_size_bytes
        self.max_alloc_timeout = max_alloc_timeout
        self.compression = CompressionType(compression)
        self.memory_cache = MemoryCache(attn_cache_bytes, max_alloc_timeout)
        if inference_max_length is None:
            hq, hkv = self.cfg.num_attention_heads, self.cfg.num_key_value_heads
            inference_max_length = 8192 if hkv < hq else 2048
        self.inference_max_length = inference_max_length
        self.session_timeout, self.step_timeout = session_timeout, step_timeout
        self.batch_lanes = batch_lanes
        self.batch_max_length = batch_max_length or min(inference_max_length, 1024)
        self.page_size, self.n_pages = page_size, n_pages
        self.prefill_token_budget = prefill_token_budget
        self._throughput_spec = throughput
        self.throughput = float(throughput) if throughput != "auto" else 1.0
        self._rps_info: Optional[dict] = None
        self.public_name = public_name
        self.update_period = update_period
        self.network_mbps = network_mbps
        self.server_side_generation = server_side_generation
        self.server_gen_params: Optional[dict] = None  # the client's leaves, once loaded
        self.prefix_cache_bytes, self.prefix_share_scope = prefix_cache_bytes, prefix_share_scope
        self.prefix_device_bytes, self.prefix_cache_policy = prefix_device_bytes, prefix_cache_policy

        self.queue = PriorityTaskQueue()
        self.backend: Optional[TransformerBackend] = None
        self.batcher: Optional[DecodeBatcher] = None
        self.handler: Optional[TransformerHandler] = None
        self.rpc_server: Optional[RpcServer] = None
        self.dht: Optional[DHTNode] = None
        self.module_uids = []
        self._state = ServerState.JOINING  # what the announce loop broadcasts
        self._next_pings: dict = {}  # successor peer id hex -> RTT seconds
        self._ping_aggregator: Optional[PingAggregator] = None
        self._announcer_task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------------ the span

    def _load_span(self) -> None:
        """Load blocks [first_block, first_block + num_blocks) and build the
        backend, the batcher and the handler over them. One block at a time:
        its dense weights are freed once quantized (fused qkv / gate+up, as
        the JAX server fuses on one device)."""
        first, n = self.first_block, self.num_blocks
        params = [
            convert_block_params(
                load_block_params(
                    self.model_path, i, dtype=self.compute_dtype, device=self.device, family=self.family, cfg=self.cfg
                ),
                self.family.name, self.quant_type, fuse=True,
            )
            for i in range(first, first + n)
        ]
        self.backend = TransformerBackend(
            self.family, self.cfg, params,
            first_block=first, n_blocks=n, device=self.device, compute_dtype=self.compute_dtype,
            max_chunk_size_bytes=self.max_chunk_size_bytes, quant_type=self.quant_type,
            kv_quant_type=self.kv_quant_type,
        )
        self.server_gen_params = self._load_server_gen_params()
        batch_lanes = self.batch_lanes
        if batch_lanes is None:
            # lanes cost their full length: cap the pool at half the cache
            # budget, as petals_tpu does (the other half serves private
            # sessions); a quantized pool's pages cost their stored bytes
            lane_bytes = self.backend.kv_bytes_per_token() * self.batch_max_length
            batch_lanes = min(8, int(self.memory_cache.max_size_bytes // 2 // max(lane_bytes, 1)))
        if batch_lanes < 1:
            raise ValueError(
                f"the cache budget of {self.memory_cache.max_size_bytes} bytes affords no lane of "
                f"{self.batch_max_length} tokens"
            )
        self.batcher = DecodeBatcher(
            self.backend, self.memory_cache, self.queue,
            n_lanes=batch_lanes, max_length=self.batch_max_length, page_size=self.page_size or None,
            n_pages=self.n_pages, prefill_token_budget=self.prefill_token_budget,
            alloc_timeout=self.max_alloc_timeout, gen_params=self.server_gen_params,
        )
        self.handler = TransformerHandler(
            self.backend, self.batcher,
            dht_prefix=self.dht_prefix, compression=self.compression,
            inference_max_length=self.inference_max_length,
            session_timeout=self.session_timeout, step_timeout=self.step_timeout,
            # rpc_info answers ONLINE, as petals_tpu's does
            server_info_fn=lambda: dataclasses.asdict(self._server_info(ServerState.ONLINE)),
            server_gen_params=self.server_gen_params,
            prefix_cache_bytes=self.prefix_cache_bytes, prefix_share_scope=self.prefix_share_scope,
            prefix_device_bytes=self.prefix_device_bytes, prefix_cache_policy=self.prefix_cache_policy,
        )

    def _load_server_gen_params(self) -> Optional[dict]:
        """The client's leaves (embeddings, final norm, head) in float32 on
        the device, for server-side generation: on a server that hosts every
        block of the model, unless ``server_side_generation`` is off (as
        petals_tpu's server.py:945-971, whose leaves are float32 too, so a
        generated token's logits are the client's own). None otherwise."""
        if not self.server_side_generation or (self.first_block, self.num_blocks) != (0, self.cfg.num_hidden_layers):
            return None
        # here, not at the top: the client package imports this module
        from petals_tpu_torch.client.from_pretrained import load_client_params

        params = load_client_params(
            self.model_path, dtype=torch.float32, device=self.device, family=self.family, cfg=self.cfg,
        )
        nbytes = sum(t.numel() * t.element_size() for t in {t.data_ptr(): t for t in params.values()}.values())
        logger.info(
            f"Server-side generation on: the client's leaves hold {nbytes} bytes on {self.device} "
            f"beside the weights, outside the KV budget of {self.memory_cache.max_size_bytes} bytes"
        )
        return params

    # ------------------------------------------------------------------ life cycle

    async def start(self) -> None:
        identity = Identity.from_seed(self.identity_seed) if self.identity_seed else Identity.generate()
        self.rpc_server = RpcServer(self.host, self.port, identity=identity)
        # listen BEFORE the DHT bootstraps: the node advertises its address
        await self.rpc_server.start()
        self.dht = await DHTNode.create(identity=identity, rpc_server=self.rpc_server, initial_peers=self.initial_peers)
        self._ping_aggregator = PingAggregator(self.dht.pool)
        if self.device.type == "cuda":
            # build (or load) the CUDA kernels now, not inside the first step
            await asyncio.to_thread(paged_flash_attention.kernel_library)
            await asyncio.to_thread(flash_attention.kernel_library)
            if self.quant_type != QuantType.NONE.value:
                await asyncio.to_thread(quant_matmul.kernel_library)
        if self._throughput_spec == "auto":
            network_mbps = await self._resolve_network_mbps()
            self._rps_info = await asyncio.to_thread(
                get_server_throughput, self.family, self.cfg, device=self.device,
                compute_dtype=self.compute_dtype, quant_type=self.quant_type, kv_quant_type=self.kv_quant_type,
                page_size=self.page_size, network_mbps=network_mbps, num_blocks=self.num_blocks,
            )
            self.throughput = self._rps_info["throughput"]
        if self.first_block is None:
            self.first_block = await self._choose_start_block()
            logger.info(f"Placed by the swarm: blocks [{self.first_block}, {self.first_block + self.num_blocks})")
        self.module_uids = module_uids(self.dht_prefix, range(self.first_block, self.first_block + self.num_blocks))

        await self._announce(ServerState.JOINING)
        # off the event loop: the node keeps answering peers meanwhile
        await asyncio.to_thread(self._load_span)
        self.queue.start()
        self.handler.register(self.rpc_server)
        self._state = ServerState.ONLINE
        await self._announce(ServerState.ONLINE)
        self._announcer_task = asyncio.create_task(self._announce_loop())
        logger.info(
            f"Serving blocks [{self.first_block}, {self.first_block + self.num_blocks}) of "
            f"{self.model_path} at {self.contact_addr.to_string()} ({self.device}, quant={self.quant_type}, "
            f"kv_quant={self.kv_quant_type}, throughput={self.throughput:.1f})"
        )

    @property
    def contact_addr(self) -> Optional[PeerAddr]:
        """The address this server announces: its DHT node's listen address."""
        return self.dht.own_addr if self.dht is not None else None

    async def shutdown(self) -> None:
        if self._announcer_task is not None:
            self._announcer_task.cancel()
            try:
                await self._announcer_task
            except asyncio.CancelledError:
                pass
        if self.dht is not None and self.module_uids:
            self._state = ServerState.OFFLINE
            try:
                await self._announce(ServerState.OFFLINE, expiration=dht_time() + OFFLINE_EXPIRATION)
            except Exception as e:  # best effort: the records expire on their own
                logger.debug(f"OFFLINE announce during shutdown failed: {e!r}")
        if self.dht is not None:
            await self.dht.shutdown()
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        if self.batcher is not None:
            await self.batcher.close()
        self.queue.shutdown()

    # ------------------------------------------------------------------ the swarm

    def _server_info(self, state: ServerState) -> ServerInfo:
        cache_tokens_left = pool = None
        if self.backend is not None:
            # the announce counts a token's stored bytes, as petals_tpu's does
            # (rpc_info counts its logical bytes)
            cache_tokens_left = int(self.memory_cache.bytes_left // max(self.backend.kv_bytes_per_token(), 1))
            pool = self.batcher.occupancy_info()
        rps = self._rps_info or {}
        return ServerInfo(
            state=state,
            throughput=self.throughput,
            inference_rps=rps.get("inference_rps"),
            forward_rps=rps.get("forward_rps"),
            network_rps=rps.get("network_rps"),
            start_block=self.first_block,
            end_block=self.first_block + self.num_blocks,
            public_name=self.public_name,
            version=petals_tpu_torch.__version__,
            compute_dtype=str(self.compute_dtype).removeprefix("torch."),
            quant_type=self.quant_type,
            adapters=(),
            cache_tokens_left=cache_tokens_left,
            next_pings=dict(self._next_pings) or None,
            # a whole-model server holding the client's leaves generates,
            # greedy and sampled alike
            server_gen=self.server_gen_params is not None,
            server_gen_sampling=self.server_gen_params is not None,
            pool=pool,
        )

    async def _announce(self, state: ServerState, expiration: Optional[float] = None) -> None:
        expiration = expiration or default_expiration(self.update_period)
        await declare_active_modules(self.dht, self.module_uids, self._server_info(state), expiration)
        if state != ServerState.OFFLINE:
            await declare_model(
                self.dht, self.dht_prefix, num_blocks=self.cfg.num_hidden_layers, expiration_time=expiration,
                public_name=self.public_name, model_type=self.family.name,
            )

    async def _announce_loop(self) -> None:
        while True:
            await asyncio.sleep(self.update_period)
            try:
                await self._measure_next_pings()
            except Exception as e:  # the announce goes out without fresh pings
                logger.debug(f"next_pings round failed: {e!r}")
            try:
                await self._announce(self._state)
            except Exception as e:
                logger.warning(f"Announce failed: {e!r}")

    async def _choose_start_block(self) -> int:
        """The start of the span over the swarm's weakest blocks."""
        uids = module_uids(self.dht_prefix, range(self.cfg.num_hidden_layers))
        infos, _ = await get_remote_module_infos(self.dht, uids)
        throughputs = compute_throughputs(infos, exclude_peer=self.dht.peer_id)
        return choose_best_start(np.asarray(throughputs), self.num_blocks)

    async def _measure_next_pings(self) -> None:
        """Ping the servers that could follow us in a chain (those serving
        our end block) and keep their RTTs for the next announce."""
        next_block = self.first_block + self.num_blocks
        if next_block >= self.cfg.num_hidden_layers:
            self._next_pings = {}
            return
        uids = module_uids(self.dht_prefix, range(next_block, next_block + 1))
        infos, addr_book = await get_remote_module_infos(self.dht, uids)
        if infos[0] is None:
            self._next_pings = {}
            return
        # OFFLINE and JOINING records linger until they expire: ping the live
        candidates = [
            addr_book[pid] for pid, si in infos[0].servers.items()
            if pid != self.dht.peer_id and pid in addr_book and si.state == ServerState.ONLINE
        ]
        candidates = random.sample(candidates, min(len(candidates), MAX_PINGED_SUCCESSORS))
        if candidates:
            await asyncio.wait_for(self._ping_aggregator.ping(candidates), 10.0)
        candidate_ids = {addr.peer_id for addr in candidates}
        self._next_pings = {
            pid.to_string(): rtt for pid, rtt in self._ping_aggregator.to_dict().items()
            if pid in candidate_ids and math.isfinite(rtt)
        }

    async def _resolve_network_mbps(self) -> Optional[float]:
        """The operator's budget, else the bandwidth to the bootstrap peers
        (None when alone or none answers: the loopback probe then rules)."""
        if self.network_mbps is not None or not self.initial_peers:
            return self.network_mbps
        peers = [p if isinstance(p, PeerAddr) else PeerAddr.from_string(p) for p in self.initial_peers]
        return await probe_swarm_bandwidth_mbps(self.dht.pool, peers)
