"""The port's server entry point: host a span of blocks of one local
checkpoint, serve ``ptu.inference`` / ``ptu.info`` on ``host:port``, and take
part in a petals_tpu swarm (petals_tpu/server/server.py, single-host).

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
loaded, fused and quantized on the device, one block at a time, and kept in
the disk cache of quantized blocks (utils/quant_cache.py, under
``cache_dir``; ``quant_weight_cache=False`` turns it off), whose entries
the next start reads instead of quantizing again; the layout is
petals_tpu's, so either package reads the other's entries. A
``model_path`` that is no local directory is a Hub repo id, streamed at
``revision`` into ``cache_dir`` (utils/hub.py), only the span's shards.
``kv_quant_type``
(int8, nf4a) keeps the paged KV pool quantized, which fits more lanes in the
same cache budget; it combines with every ``quant_type``. ``page_size=0``
selects the dense lane pool in place of the paged one. Sessions that fit no
lane (batch > 1, a sub-span, a longer ``max_length``) are served from
private dense caches out of the same budget; ``batching=False``
(``--no_batching``) serves every session so, with no pool at all.

The span moves (petals_tpu/server/server.py:1034-1160, the single-host
arm): with ``mean_balance_check_period`` > 0 a loop looks at the swarm
every period (times 0.5 to 1.5) and moves the span when
``should_choose_other_blocks`` finds the swarm's quality under
``balance_quality``; ``resize(first_block)`` moves it on demand (the
autoscaler's actuator, swarm/). A move announces the old blocks OFFLINE,
the new ones JOINING, parks the live sessions and pushes them to replicas
of the old span, loads the new span, hands the handler a new backend and
pool (``swap_backend``: the old pool closes, the new one opens and captures
its step programs), and announces ONLINE.

A server that hosts the whole model (``server_side_generation``, the
default) also loads the client's leaves (embeddings, final norm, head) in
float32 and generates tokens in its own step programs for a client that
asks (``gen_tokens``); it announces ``server_gen`` and
``server_gen_sampling`` then, as petals_tpu's does. The leaves lie beside
the weights, outside the KV budget (``attn_cache_bytes``): about 1.05 GB at
Mistral-7B's widths, logged at load.

Speculative decoding (server/spec_decode.py): ``draft_model``, a local
path of a small checkpoint, is loaded beside such a span (``spec_k``
drafts a lane a tick, a ``draft_window``-token window, its blocks
quantized per ``draft_quant_type``, nf4a by default) on a paged pool, and
the batcher verifies its drafts in one paged step a tick; the announce then
carries ``spec_k``. The stream is plain decode's. A server that cannot
take a draft (not a whole-model span with server-side generation on a
paged pool), or whose draft fails to load, logs a warning and serves plain
decode, as petals_tpu's does.

The prompt-prefix cache (server/prefix_cache.py) is on with petals_tpu's
defaults: a 256 MiB host tier (``prefix_cache_bytes``), a 256 MiB HBM tier
(``prefix_device_bytes``, which an auto-sized KV budget gives up, as
petals_tpu's does), the ``radix`` policy and ``swarm`` sharing; a paged
pool's page size must then divide its 128-token segments.

The session scheduler (server/scheduler.py): ``swap_host_bytes`` (default
0: off) gives the paged pool a host-memory swap tier, so an exhausted pool
preempts an idle session (``preemption_policy``: lru, largest or off)
instead of failing the request at its timeout. One resource ledger
(telemetry/ledger.py, the process's) meters every session for the
scheduler's fair share, the replies' ``usage`` and the prefix cache's
billing; ServerInfo.pool carries the scheduler's summary.

Behind NAT (``relay_via="host:port"``, petals_tpu/server/server.py:316-347):
the server opens no listener; its DHT node is query-only, a RelayRegistrar
(rpc/relay.py) keeps a control connection to the relay and serves the RPC
methods on the reverse connections the relay splices, and the announced
contact address is the relay circuit (``relay+host:port/peer``). Its
network rate is priced by ``RELAY_PENALTY`` (server/throughput.py). Every
server answers ``reach.check`` (server/reachability.py).

Drain and phase tiers (petals_tpu/server/server.py:488-591, 716):
``drain()`` parks every live session's KV in host memory BEFORE it refuses
steps, announces OFFLINE, then pushes each parked session to the
highest-throughput ONLINE replica covering its span (decode-tier replicas
first), so that the client adopts it there; the server keeps answering
``ptu.session_export`` until ``shutdown()``, which aborts a push in flight.
``phase_tier`` ("generalist", "prefill" or "decode") is announced for
clients' phase-aware routing; a prefill-tier server hands a session's KV to
a decode-tier replica when the client asks (``ptu.session_handoff``).

Telemetry (petals_tpu/server/server.py:440-462, 649-770): with
``metrics_port`` (0: ephemeral) a ``MetricsServer`` serves ``/metrics``,
``/journal`` and ``/ledger``; with ``trace_dir`` (or
``PETALS_TPU_TRACE_DIR``) a torch.profiler capture runs from startup for
``trace_window_seconds()`` and is written there as a Chrome trace (a
capture that cannot start fails the start). The announce carries
``telemetry`` (``telemetry_digest``, size-capped), ``compile_stats`` (the
step-program observatory), ``integrity`` (the digest of a self-probe
through ``ptu.probe`` with the server's quarantine flag) and
``metrics_port``. The self-probe runs at every announce but OFFLINE, as
petals_tpu's does: it goes through the chaos plane's ``integrity.corrupt``
site, and a moved span probes its new blocks. ``request_timeout`` bounds a
stateless forward or probe. The chaos plane (chaos/) may drop an announce
(``dht.announce``).

LoRA adapters (petals_tpu/server/server.py:851-861): ``adapters`` lists
PEFT checkpoint directories; each is loaded for the span's blocks
(utils/peft.py) when the span loads, kept per block in the compute dtype
on the device, and announced by name (sorted); requests pick one with
``active_adapter``. A span with adapters loads unfused, as petals_tpu's
does: the adapters target the separate projections.

Tensor and sequence parallelism (petals_tpu/server/server.py's
``num_tp_devices`` and ``num_sp_devices``, one host): ``num_tp_devices`` > 1
splits the span over that many devices, ``num_sp_devices`` > 1 replicates
it over that many sp ranks (ring attention on the stateless forward and
backward, query-sharded cached prefill), over the first tp x sp of
``tp_devices`` in grid order (parallel/mesh.py ``serving_devices``;
default: the visible CUDA devices; with ``device="cpu"``, that many CPU
shards), in this one process (server/backend.py). Blocks load unfused
under tp > 1 or with adapters, as the JAX server's do (a quantized span
at sp alone stays fused, and its split fails at load with the JAX
package's KeyError), and are split as each loads; the batcher keeps the
dense lane pool, the prefix cache keeps host copies only, no draft is
loaded, and the throughput probe times a span split over tp alone (it
ignores sp, as petals_tpu's does). ``kv_quant_type`` is refused with a
mesh, and sp > 1 for a family without ring attention (Gemma-2), with
ValueError; the ``+o`` kinds and the families without a split
(parallel/tp.py) fail at load, as in the JAX package. LoRA adapters are
served on a mesh: each shard takes its part of A or B.

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
import time
from typing import Optional, Sequence

import numpy as np
import torch

import petals_tpu_torch
from petals_tpu_torch import chaos
from petals_tpu_torch.data_structures import ServerInfo, ServerState
from petals_tpu_torch.dht.identity import Identity
from petals_tpu_torch.dht.node import DHTNode, dht_time
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.models.registry import num_kv_heads
from petals_tpu_torch.ops import fingerprint as fp_ops
from petals_tpu_torch.ops import flash_attention, grouped_matmul, paged_flash_attention, quant_matmul
from petals_tpu_torch.ops.paged_attention import KV_QUANT_KINDS
from petals_tpu_torch.parallel.mesh import serving_devices
from petals_tpu_torch.parallel.sp import replicate_over_sp
from petals_tpu_torch.parallel.tp import shard_span_params
from petals_tpu_torch.rpc.serialization import CompressionType
from petals_tpu_torch.rpc.server import RpcServer
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.batching import DecodeBatcher
from petals_tpu_torch.server.block_selection import (
    choose_best_start,
    compute_throughputs,
    should_choose_other_blocks,
)
from petals_tpu_torch.server.block_utils import choose_num_blocks
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params, resolve_model_path
from petals_tpu_torch.server.handler import TransformerHandler, _log_failure
from petals_tpu_torch.server.memory_cache import MemoryCache
from petals_tpu_torch.server.prefix_cache import resolve_device_bytes
from petals_tpu_torch.server.reachability import ReachabilityProtocol
from petals_tpu_torch.server.scheduler import PREEMPTION_POLICIES
from petals_tpu_torch.server.task_queue import PriorityTaskQueue
from petals_tpu_torch.telemetry.ledger import get_ledger
from petals_tpu_torch.server.throughput import get_server_throughput
from petals_tpu_torch.telemetry.exposition import MetricsServer, telemetry_digest
from petals_tpu_torch.telemetry.integrity import cap_announce_payload, get_quarantine
from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.observatory import get_observatory
from petals_tpu_torch.utils import quant_cache, tracing
from petals_tpu_torch.utils.asyncio_utils import log_exception_callback
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
from petals_tpu_torch.utils.random_utils import sample_up_to

logger = logging.getLogger(__name__)

DEFAULT_UPDATE_PERIOD = 30.0
OFFLINE_EXPIRATION = 60.0  # how long the final OFFLINE announce stays readable, at least
# disaggregated serving tiers: generalists serve both phases; a prefill-tier
# replica hands finished prefills to a decode-tier one (handler.rpc_session_handoff)
PHASE_TIERS = ("generalist", "prefill", "decode")
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
        num_tp_devices: Optional[int] = None,  # > 1: split the span over this many devices (tensor parallel)
        num_sp_devices: Optional[int] = None,  # > 1: sequence parallel over this many ranks
        tp_devices: Optional[Sequence] = None,  # the grid's devices, tp x sp (default: the visible CUDA devices)
        compute_dtype: torch.dtype = torch.bfloat16,
        attn_cache_bytes: Optional[int] = None,  # None: 15% of the card's memory
        max_chunk_size_bytes: int = 256 * 1024 * 1024,
        max_alloc_timeout: float = 600.0,
        compression: str = "none",
        relay_via: Optional[str] = None,  # "host:port" of a relay peer: serve from behind NAT
        inference_max_length: Optional[int] = None,  # None: 8192 for GQA/MQA, 2048 otherwise
        request_timeout: float = 3 * 60,  # a stateless forward or probe
        session_timeout: float = 30 * 60,
        step_timeout: float = 5 * 60,
        metrics_port: Optional[int] = None,  # /metrics, /journal, /ledger over HTTP; None disables, 0 ephemeral
        trace_dir: Optional[str] = None,  # a torch.profiler trace of the first seconds; None: $PETALS_TPU_TRACE_DIR
        batch_lanes: Optional[int] = None,  # None: auto-size to the cache budget (<=8)
        batch_max_length: Optional[int] = None,  # None: min(inference_max_length, 1024)
        page_size: int = 64,  # paged KV: tokens per page; 0 = the dense lane pool
        n_pages: Optional[int] = None,
        prefill_token_budget: int = 512,
        swap_host_bytes: int = 0,  # host-memory swap tier (session preemption); 0 disables
        preemption_policy: str = "lru",  # victim choice on pool exhaustion: lru | largest | off
        ledger=None,  # a ResourceLedger; None: the process's (telemetry/ledger.py)
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
        phase_tier: str = "generalist",  # disaggregated serving: "generalist" | "prefill" | "decode"
        draft_model: Optional[str] = None,  # a small local checkpoint for speculative decoding
        spec_k: int = 4,  # drafts verified per lane per tick when draft_model is set
        draft_window: Optional[int] = None,  # the draft's context window in tokens; None: 64
        draft_quant_type: str = "nf4a",  # the draft's block quantization
        adapters: Sequence[str] = (),  # PEFT checkpoint dirs to host (utils/peft.py)
        mean_balance_check_period: float = 0.0,  # > 0: look for a better span this often (seconds)
        balance_quality: float = 0.75,  # move when the swarm's quality falls under this
        revision: str = "main",  # the Hub revision a repo id streams from (utils/hub.py)
        cache_dir=None,  # the Hub's and the quantized blocks' disk cache; None: utils/disk_cache.py's
        quant_weight_cache: bool = True,  # keep quantized blocks across restarts (utils/quant_cache.py)
        batching: bool = True,  # False: no lane pool, every session on a private cache
    ):
        if phase_tier not in PHASE_TIERS:
            raise ValueError(f"phase_tier must be one of {PHASE_TIERS}, got {phase_tier!r}")
        if kv_quant_type not in KV_QUANT_KINDS:
            raise ValueError(f"kv_quant_type must be one of {KV_QUANT_KINDS}, got {kv_quant_type!r}")
        if page_size is None or page_size < 0:
            raise ValueError(f"page_size must be >= 1, or 0 for the dense lane pool; got {page_size}")
        if kv_quant_type != "none" and not page_size:
            raise ValueError(
                "kv_quant_type requires the paged KV pool (--page_size > 0): the "
                "dense lane pool has no quantized storage path"
            )
        if preemption_policy not in PREEMPTION_POLICIES:
            raise ValueError(f"preemption_policy must be one of {PREEMPTION_POLICIES}, got {preemption_policy!r}")
        if swap_host_bytes < 0:
            raise ValueError(f"swap_host_bytes must be >= 0, got {swap_host_bytes}")
        if not isinstance(throughput, (int, float)) and throughput != "auto":
            raise ValueError(f'throughput must be a number or "auto", got {throughput!r}')
        self.device = resolve_device(device)
        self.num_tp_devices, self.num_sp_devices = num_tp_devices, num_sp_devices
        tp, sp = num_tp_devices or 1, num_sp_devices or 1
        # the grid (tp x sp, grid order), and sp rank 0's shards' devices
        self.mesh_devices = self.tp_devices = None
        if tp * sp > 1:
            if kv_quant_type != "none":
                raise ValueError("kv_quant_type requires a mesh-less server (paged pool only)")
            # on the CPU every shard is a CPU shard unless the caller lists them
            pool = tp_devices if tp_devices is not None else (
                [self.device] * (tp * sp) if self.device.type == "cpu" else None)
            self.mesh_devices = serving_devices(tp, sp, pool)
            self.device = self.mesh_devices[0]
            if tp > 1:
                self.tp_devices = self.mesh_devices[::sp]
        self.quant_type = QuantType(quant_type).value
        self.kv_quant_type = kv_quant_type
        self.model_path = model_path
        self.revision, self.cache_dir = revision, cache_dir
        self.quant_weight_cache = quant_weight_cache
        # the same revision and cache as the weights, or the shapes could differ
        self.family, self.cfg = get_block_config(model_path, revision=revision, cache_dir=cache_dir)
        if sp > 1 and not self.family.supports_ring_attention:
            raise ValueError(
                f"num_sp_devices>1 needs ring attention, which {self.family.name} "
                f"does not support (plain causal only) — the sp devices would "
                f"sit idle holding replicated parameters"
            )
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
            hq, hkv = self.cfg.num_attention_heads, num_kv_heads(self.cfg)
            inference_max_length = 8192 if hkv < hq else 2048
        self.inference_max_length = inference_max_length
        self.session_timeout, self.step_timeout = session_timeout, step_timeout
        self.request_timeout = request_timeout
        self.metrics_port = metrics_port
        self.trace_dir = trace_dir
        self._metrics_server: Optional[MetricsServer] = None
        self._trace_flush_task: Optional[asyncio.Task] = None
        self._integrity_info: Optional[dict] = None  # the self-probe's digest, once taken
        self.batch_lanes = batch_lanes
        self.batch_max_length = batch_max_length or min(inference_max_length, 1024)
        self.page_size, self.n_pages = page_size, n_pages
        self.prefill_token_budget = prefill_token_budget
        self.swap_host_bytes, self.preemption_policy = swap_host_bytes, preemption_policy
        self.ledger = ledger if ledger is not None else get_ledger()
        self.relay_via = relay_via
        self._relay_registrar = None
        self._contact_addr: Optional[PeerAddr] = None  # the relay circuit, behind a relay
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
        self.phase_tier = phase_tier
        self.draft_model_path = draft_model
        self.spec_k = int(spec_k)
        self.draft_window = draft_window
        self.draft_quant_type = draft_quant_type
        self._draft_model = None  # loaded with the span (_load_draft_model)
        self.adapter_paths = list(adapters)
        self.mean_balance_check_period = mean_balance_check_period
        self.balance_quality = balance_quality
        self.batching = batching
        self.identity: Optional[Identity] = None

        self.queue = PriorityTaskQueue()
        self.backend: Optional[TransformerBackend] = None
        self.handler: Optional[TransformerHandler] = None
        self.rpc_server: Optional[RpcServer] = None
        self.dht: Optional[DHTNode] = None
        self.module_uids = []
        self._state = ServerState.JOINING  # what the announce loop broadcasts
        self._next_pings: dict = {}  # successor peer id hex -> RTT seconds
        self._ping_aggregator: Optional[PingAggregator] = None
        self._announcer_task: Optional[asyncio.Task] = None
        self._balancer_task: Optional[asyncio.Task] = None
        # what each span load took (seconds): the weights, then the pool's
        # step programs; and the quantized-block cache's hits and misses
        self.load_stats = {"load_s": 0.0, "warm_s": 0.0, "cache_hits": 0, "cache_misses": 0}

    # ------------------------------------------------------------------ the span

    @property
    def batcher(self) -> Optional[DecodeBatcher]:
        """The lane pool the handler serves from (None under
        ``batching=False``); a span move replaces it."""
        return self.handler.batcher if self.handler is not None else None

    def _load_span(self) -> None:
        """Load the span and build the backend, the batcher and the handler
        over it."""
        self.backend = self._build_backend(self._load_span_params(self.first_block, self.num_blocks))
        self.server_gen_params = self._load_server_gen_params()
        self.handler = TransformerHandler(
            self.backend, self._make_batcher(self.backend),
            dht_prefix=self.dht_prefix, compression=self.compression,
            memory_cache=self.memory_cache, queue=self.queue, ledger=self.ledger,
            inference_max_length=self.inference_max_length,
            session_timeout=self.session_timeout, step_timeout=self.step_timeout,
            request_timeout=self.request_timeout,
            # rpc_info answers ONLINE, as petals_tpu's does
            server_info_fn=lambda: dataclasses.asdict(self._server_info(ServerState.ONLINE)),
            server_gen_params=self.server_gen_params,
            prefix_cache_bytes=self.prefix_cache_bytes, prefix_share_scope=self.prefix_share_scope,
            prefix_device_bytes=self.prefix_device_bytes, prefix_cache_policy=self.prefix_cache_policy,
            identity=self.identity,
        )

    def _load_span_params(self, first: int, n: int) -> list:
        """Blocks [first, first + n), one at a time: its dense weights are
        freed once quantized (fused qkv / gate+up, as the JAX server fuses,
        unless adapters target the separate projections or tensor
        parallelism splits them: a fused qkv's parts are not head-aligned)
        or, under a mesh, once split over the shards and replicated over
        the sp ranks."""
        t0 = time.perf_counter()
        fuse = (self.num_tp_devices or 1) <= 1 and not self.adapter_paths
        params = [self._load_mesh_block(self._load_block_converted(i, fuse=fuse)) for i in range(first, first + n)]
        # the host's wall: a device-wide synchronize here would break another
        # server's capture in the same process
        self.load_stats["load_s"] = time.perf_counter() - t0
        return params

    def _load_mesh_block(self, block: dict):
        """One loaded block split over the mesh's tp shards and replicated
        over its sp ranks (the block itself without a mesh)."""
        if self.mesh_devices is None:
            return block
        sp = self.num_sp_devices or 1
        shards = shard_span_params([block], self.mesh_devices[::sp], self.family.name, self.cfg)[0]
        return replicate_over_sp(shards, self.mesh_devices, sp) if sp > 1 else shards

    def _load_block_converted(self, block_index: int, *, fuse: bool) -> dict:
        """One block, quantized per ``quant_type``. A quantized block is a
        pure function of (checkpoint, kind, fuse), so it is read from the
        disk cache (utils/quant_cache.py) when an earlier start of either
        package wrote it, and written there otherwise
        (petals_tpu/server/server.py:818-846)."""
        use_cache = self.quant_weight_cache and self.quant_type != QuantType.NONE.value
        if use_cache:
            path = quant_cache.cache_path(
                self.model_path, block_index, self.quant_type, fuse=fuse, revision=self.revision,
                cache_dir=self.cache_dir, dtype_tag=str(self.compute_dtype).removeprefix("torch."),
            )
            cached = quant_cache.load_quantized_block(path, device=self.device)
            if cached is not None:
                self.load_stats["cache_hits"] += 1
                return cached
            self.load_stats["cache_misses"] += 1
        params = convert_block_params(
            load_block_params(
                self.model_path, block_index, dtype=self.compute_dtype, device=self.device, family=self.family,
                cfg=self.cfg, revision=self.revision, cache_dir=self.cache_dir,
            ),
            self.family.name, self.quant_type, fuse=fuse,
        )
        if use_cache:
            try:
                quant_cache.save_quantized_block(path, params)
            except OSError as e:
                logger.warning(f"Could not cache quantized block {block_index}: {e!r}")
        return params

    def _build_backend(self, params: list) -> TransformerBackend:
        backend = TransformerBackend(
            self.family, self.cfg, params,
            first_block=self.first_block, n_blocks=self.num_blocks, device=self.device,
            compute_dtype=self.compute_dtype, max_chunk_size_bytes=self.max_chunk_size_bytes,
            quant_type=self.quant_type, kv_quant_type=self.kv_quant_type, tp_devices=self.mesh_devices,
            num_sp_devices=self.num_sp_devices or 1,
        )
        self._install_adapters(backend)
        return backend

    def _make_batcher(self, backend: TransformerBackend) -> Optional[DecodeBatcher]:
        """The lane pool over ``backend``, None under ``batching=False``."""
        if not self.batching:
            return None
        batch_lanes = self.batch_lanes
        if batch_lanes is None:
            # lanes cost their full length: cap the pool at half the cache
            # budget, as petals_tpu does (the other half serves private
            # sessions); a quantized pool's pages cost their stored bytes
            lane_bytes = backend.kv_bytes_per_token() * self.batch_max_length
            batch_lanes = min(8, int(self.memory_cache.max_size_bytes // 2 // max(lane_bytes, 1)))
        if batch_lanes < 1:
            raise ValueError(
                f"the cache budget of {self.memory_cache.max_size_bytes} bytes affords no lane of "
                f"{self.batch_max_length} tokens"
            )
        draft = self._load_draft_model()
        return DecodeBatcher(
            backend, self.memory_cache, self.queue,
            n_lanes=batch_lanes, max_length=self.batch_max_length, page_size=self.page_size or None,
            n_pages=self.n_pages, prefill_token_budget=self.prefill_token_budget,
            alloc_timeout=self.max_alloc_timeout, gen_params=self.server_gen_params,
            swap_host_bytes=self.swap_host_bytes, preemption_policy=self.preemption_policy, ledger=self.ledger,
            draft_model=draft, spec_k=self.spec_k if self.draft_model_path else None,
        )

    def _grid_label(self) -> str:
        return (f"tp={self.num_tp_devices or 1} x sp={self.num_sp_devices or 1} over "
                + ",".join(map(str, self.mesh_devices)))

    def _install_adapters(self, backend: TransformerBackend) -> None:
        """Load every adapter of ``adapter_paths`` for the span's blocks onto
        ``backend``, keyed by name."""
        if not self.adapter_paths:
            return
        from petals_tpu_torch.utils.peft import load_adapter, stack_adapter

        block_range = range(self.first_block, self.first_block + self.num_blocks)
        for path in self.adapter_paths:
            adapter = load_adapter(path, self.family.name, block_range=block_range)
            per_block = stack_adapter(adapter, self.first_block, self.num_blocks, self.compute_dtype, self.device)
            backend.adapters[adapter.name] = (per_block, adapter.scaling)
        logger.info(f"Hosting adapters: {sorted(backend.adapters)}")

    def _load_draft_model(self):
        """The speculative-decoding draft (server/spec_decode.py), loaded
        beside the span on its device: eligible as server-side generation
        is (the verify step embeds and samples with the client's leaves), on
        a paged pool (the verify step's rows are chunk writes into pages).
        An ineligible server, or a draft that fails to load, serves plain
        decode with a warning, as petals_tpu's does. The draft computes in
        float32, as petals_tpu's does, whatever the span's dtype."""
        if not self.draft_model_path or self.spec_k < 1:
            return None
        if self.server_gen_params is None or not self.page_size or self.mesh_devices is not None:
            logger.warning(
                "Speculative decoding disabled: --draft_model needs a full-span single-host server with "
                "server-side generation and a paged lane pool"
            )
            return None
        if self._draft_model is not None:
            return self._draft_model
        try:
            from petals_tpu_torch.server.spec_decode import DEFAULT_WINDOW, DraftModel

            self._draft_model = DraftModel.from_pretrained(
                self.draft_model_path, spec_k=self.spec_k, window=int(self.draft_window or DEFAULT_WINDOW),
                quant_type=self.draft_quant_type, device=self.device,
            )
        except Exception as e:
            logger.warning(f"Speculative decoding disabled (draft load failed): {e}")
            self._draft_model = None
        return self._draft_model

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

        path = resolve_model_path(
            self.model_path, prefixes=tuple(self.family.hf_client_prefixes), revision=self.revision,
            cache_dir=self.cache_dir,
        )
        params = load_client_params(
            path, dtype=torch.float32, device=self.device, family=self.family, cfg=self.cfg,
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
        self.identity = identity
        self.rpc_server = RpcServer(self.host, self.port, identity=identity)
        if self.relay_via is not None:
            await self._start_behind_relay(identity)
        else:
            # listen BEFORE the DHT bootstraps: the node advertises its address
            await self.rpc_server.start()
            self.dht = await DHTNode.create(
                identity=identity, rpc_server=self.rpc_server, initial_peers=self.initial_peers
            )
        ReachabilityProtocol().register(self.rpc_server)
        self._ping_aggregator = PingAggregator(self.dht.pool)
        if self.device.type == "cuda":
            # build (or load) the CUDA kernels now, not inside the first step
            await asyncio.to_thread(paged_flash_attention.kernel_library)
            await asyncio.to_thread(flash_attention.kernel_library)
            if self.quant_type != QuantType.NONE.value:
                await asyncio.to_thread(quant_matmul.kernel_library)
            if self.family.block_arch == "mixtral":  # its sparse experts' grouped product
                await asyncio.to_thread(grouped_matmul.kernel_library)
        if self._throughput_spec == "auto":
            network_mbps = await self._resolve_network_mbps()
            self._rps_info = await asyncio.to_thread(
                get_server_throughput, self.family, self.cfg, device=self.device,
                compute_dtype=self.compute_dtype, quant_type=self.quant_type, kv_quant_type=self.kv_quant_type,
                # a mesh serves the dense lane pool; the probe splits over tp
                # alone and ignores sp, as petals_tpu's does
                page_size=0 if self.mesh_devices is not None else self.page_size, network_mbps=network_mbps,
                num_blocks=self.num_blocks, using_relay=self.relay_via is not None, tp_devices=self.tp_devices,
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
        if tracing.start_trace(self.trace_dir) is not None:
            # a bounded window: the profiler buffers every event until it stops
            async def flush_trace():
                await asyncio.sleep(tracing.trace_window_seconds())
                # on the loop's thread: the profiler stops where it started
                tracing.stop_trace()

            self._trace_flush_task = asyncio.create_task(flush_trace())
            self._trace_flush_task.add_done_callback(_log_failure("trace flush"))
        if self.metrics_port is not None:
            try:
                self._metrics_server = MetricsServer(port=self.metrics_port)
                logger.info(f"Prometheus /metrics on port {self._metrics_server.port}")
            except OSError as e:  # the port is taken: serve without the scrape endpoint
                logger.warning(f"Could not bind metrics port {self.metrics_port}: {e}")
        await self._warm_self_probe()
        self._state = ServerState.ONLINE
        await self._announce(ServerState.ONLINE)
        self._announcer_task = asyncio.create_task(self._announce_loop())
        self._announcer_task.add_done_callback(log_exception_callback(logger, "announce loop"))
        if self.mean_balance_check_period > 0:
            self._balancer_task = asyncio.create_task(self._balance_loop())
            self._balancer_task.add_done_callback(log_exception_callback(logger, "balance loop"))
        logger.info(
            f"Serving blocks [{self.first_block}, {self.first_block + self.num_blocks}) of "
            f"{self.model_path} at {self.contact_addr.to_string()} "
            f"({self.device if self.mesh_devices is None else self._grid_label()}, "
            f"quant={self.quant_type}, "
            f"kv_quant={self.kv_quant_type}, throughput={self.throughput:.1f})"
        )

    async def _start_behind_relay(self, identity: Identity) -> None:
        """No listener at all: a query-only DHT node, the RPC methods served
        on reverse connections through the relay, and the relay circuit as
        the contact address. Peers still probe a relayed server (pings for
        next_pings, the bandwidth probe), so it answers those here."""
        from petals_tpu_torch.rpc.relay import RelayRegistrar
        from petals_tpu_torch.utils.bandwidth import BandwidthProtocol

        relay_host, relay_port = self.relay_via.rsplit(":", 1)
        self.dht = await DHTNode.create(identity=identity, client_mode=True, initial_peers=self.initial_peers)
        self._relay_registrar = RelayRegistrar(relay_host, int(relay_port), identity, self.rpc_server)
        await self._relay_registrar.start()
        await self._relay_registrar.wait_registered()
        self._contact_addr = PeerAddr(relay_host, int(relay_port), identity.peer_id, relayed=True)

        async def ping(_payload, _ctx):
            return {"peer_id": identity.peer_id.to_string()}

        self.rpc_server.add_unary_handler("dht.ping", ping)
        BandwidthProtocol().register(self.rpc_server)
        logger.info(f"Serving behind relay {self.relay_via} (no inbound listener)")

    @property
    def contact_addr(self) -> Optional[PeerAddr]:
        """The address this server announces: the relay circuit behind a
        relay, else its DHT node's listen address."""
        if self._contact_addr is not None:
            return self._contact_addr
        return self.dht.own_addr if self.dht is not None else None

    async def drain(self, park_ttl: float = 60.0, migrate: bool = True) -> int:
        """The prelude to a graceful shutdown: park every live session's KV
        in host memory, refuse new sessions and steps, announce OFFLINE,
        and (``migrate``) push each parked session to a replica covering its
        span, where the client adopts it without its KV crossing the
        client's link. Exports keep being served until ``shutdown()``.
        Returns the number of parked sessions."""
        parked = 0
        if self.handler is not None:
            # park BEFORE refusing steps: flipping `draining` first lets an
            # in-flight step raise and unregister its session while the park
            # awaits, and the export would then find nothing. A step landing
            # between the snapshot and the flip only makes the parked copy
            # stale, which clients top up by replaying the tail.
            parked = await self.handler.park_sessions(ttl=park_ttl)
            self.handler.draining = True
        self._state = ServerState.OFFLINE
        if self.dht is not None and self.module_uids:
            try:
                await self._announce(ServerState.OFFLINE, expiration=self._offline_expiration())
            except Exception as e:  # best effort: the records expire on their own
                logger.debug(f"OFFLINE announce during drain failed: {e!r}")
        if parked:
            logger.info(f"Draining: parked {parked} session(s) for migration")
        if parked and migrate:
            pushed = await self._migrate_parked_sessions()
            if pushed:
                logger.info(f"Drain-to-migrate: pushed {pushed} session(s) to replicas")
        return parked

    async def _migrate_parked_sessions(self, deadline_s: float = 30.0) -> int:
        """Push every parked session's KV to a live replica covering its
        span. A session with no such replica, or whose push fails, stays
        parked for the client's export or replay. Returns how many moved."""
        handler = self.handler
        if handler is None or not handler._parked or self.dht is None:
            return 0
        uids = module_uids(self.dht_prefix, range(self.cfg.num_hidden_layers))
        try:
            infos, addr_book = await get_remote_module_infos(self.dht, uids)
        except Exception as e:
            logger.warning(f"Drain-to-migrate skipped: swarm lookup failed ({e!r})")
            return 0
        migrated = 0
        for session_id, snap in list(handler._parked.items()):
            dest = self._pick_migration_target(infos, addr_book, snap["start"], snap["end"])
            if dest is None:
                logger.info(
                    f"No live replica covers blocks [{snap['start']}, {snap['end']}): "
                    f"session {session_id!r} stays parked for the client's export"
                )
                continue
            peer_id, addr = dest
            if await handler.migrate_parked_to(
                session_id, snap, peer_id.to_string(), addr.to_string(), deadline_s=deadline_s,
            ):
                migrated += 1
        return migrated

    def _pick_migration_target(self, infos, addr_book, start: int, end: int):
        """The highest-throughput ONLINE peer (not this one) serving every
        block of [start, end) at a known address, decode-tier replicas
        first (a migrated session is mid-generation); None when none."""
        candidates = None
        for i in range(start, end):
            info = infos[i] if i < len(infos) else None
            if info is None:
                return None
            here = {
                pid for pid, si in info.servers.items()
                if si.state == ServerState.ONLINE and pid in addr_book and pid != self.dht.peer_id
            }
            candidates = here if candidates is None else candidates & here
            if not candidates:
                return None
        best, best_key = None, (-1, -1.0)
        for pid in candidates:
            si = infos[start].servers[pid]
            key = (1 if getattr(si, "phase_tier", None) == "decode" else 0, si.throughput or 0.0)
            if key > best_key:
                best, best_key = pid, key
        return (best, addr_book[best]) if best is not None else None

    async def shutdown(self) -> None:
        if self.handler is not None:
            # a drain-to-migrate push racing shutdown must not hang teardown
            # on a slow peer: the aborted sessions stay parked
            self.handler.abort_migrations()
        for task in (self._balancer_task, self._announcer_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if self.dht is not None and self.module_uids:
            self._state = ServerState.OFFLINE
            try:
                await self._announce(ServerState.OFFLINE, expiration=self._offline_expiration())
            except Exception as e:  # best effort: the records expire on their own
                logger.debug(f"OFFLINE announce during shutdown failed: {e!r}")
        if self.dht is not None:
            await self.dht.shutdown()
        if self._relay_registrar is not None:
            await self._relay_registrar.stop()
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        if self.handler is not None:
            await self.handler.close()
        if self.batcher is not None:
            await self.batcher.close()
        self.queue.shutdown()
        if self._trace_flush_task is not None:
            self._trace_flush_task.cancel()
        tracing.stop_trace()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        # the journal's JSONL sink flushes and detaches once nothing emits
        get_journal().close()

    # ------------------------------------------------------------------ the swarm

    def _server_info(self, state: ServerState) -> ServerInfo:
        cache_tokens_left = pool = None
        if self.backend is not None:
            # the announce counts a token's stored bytes, as petals_tpu's does
            # (rpc_info counts its logical bytes)
            cache_tokens_left = int(self.memory_cache.bytes_left // max(self.backend.kv_bytes_per_token(), 1))
            pool = self.batcher.occupancy_info() if self.batcher is not None else None
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
            adapters=tuple(sorted(self.backend.adapters) if self.backend is not None else ()),
            cache_tokens_left=cache_tokens_left,
            next_pings=dict(self._next_pings) or None,
            # a whole-model server holding the client's leaves generates,
            # greedy and sampled alike
            server_gen=self.server_gen_params is not None,
            server_gen_sampling=self.server_gen_params is not None,
            # k drafts verified a tick (informational: the stream is plain decode's)
            spec_k=self.spec_k if self._draft_model is not None else None,
            pool=pool,
            # the telemetry digest (the announce loop's cadence makes tok_s an
            # update_period average), the step-program observatory's digest,
            # the self-probe's integrity digest and where /metrics lives
            telemetry=self._telemetry_digest(),
            compile_stats=get_observatory().compile_stats(),
            integrity=self._integrity_info,
            metrics_port=self._metrics_server.port if self._metrics_server is not None else None,
            # generalists announce it too, which tells an explicit
            # generalist from a server that predates tiers
            phase_tier=self.phase_tier,
        )

    @staticmethod
    def _telemetry_digest() -> Optional[dict]:
        try:
            # size-capped: the digest rides every widely replicated announce
            return cap_announce_payload(telemetry_digest())
        except Exception as e:  # an announce never fails over metrics
            logger.debug(f"telemetry digest failed: {e!r}")
            return None

    async def _refresh_integrity(self) -> None:
        """The announce's integrity view: the digest of a self-probe through
        ``ptu.probe``, the path an external canary prober takes (so an
        injected ``integrity.corrupt`` shows in the announce too), and this
        server's quarantine flag in the process's registry. A failure
        leaves the previous view in place."""
        if self.handler is None:
            return
        try:
            reply = await self.handler.rpc_probe({"tokens": 4}, None)
            peer = self.identity.peer_id.to_string() if self.identity is not None else ""
            self._integrity_info = cap_announce_payload({
                "self_digest": fp_ops.digest_hex(np.asarray(reply["fp"], dtype=np.float32)),
                "fp_seed": int(reply["fp_seed"]),
                "span": f"{reply['first_block']}:{reply['first_block'] + reply['n_blocks']}",
                "quarantined": bool(peer and get_quarantine().is_quarantined(peer)),
            })
        except Exception as e:
            logger.debug(f"integrity digest refresh failed: {e!r}")

    async def _warm_self_probe(self) -> None:
        """On a card the self-probe's forward program runs eagerly on its
        first call and captures on its second: the ONLINE announce's probe
        is the second, so the capture happens while the span comes up, never
        at a later announce while the card serves."""
        if self.device.type == "cuda":
            await self._refresh_integrity()

    def _offline_expiration(self) -> float:
        """An OFFLINE record's expiration: OFFLINE_EXPIRATION from now, and
        never before the last announce's, since a DHT store keeps the value
        that expires last (an update period over 30 s would otherwise leave
        the ONLINE record standing)."""
        return max(dht_time() + OFFLINE_EXPIRATION, default_expiration(self.update_period))

    async def _announce(self, state: ServerState, expiration: Optional[float] = None) -> None:
        if chaos.ENABLED and chaos.fire(chaos.SITE_ANNOUNCE) is not None:
            # an injected announce loss: the record ages out, as if the store
            # never reached the network
            logger.warning(f"chaos: dropping the DHT announce ({state})")
            return
        expiration = expiration or default_expiration(self.update_period)
        if state != ServerState.OFFLINE:
            # the ServerInfo below carries this period's integrity view
            await self._refresh_integrity()
        await declare_active_modules(
            self.dht, self.module_uids, self._server_info(state), expiration, contact_addr=self._contact_addr
        )
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

    async def _choose_start_block(self, throughputs=None) -> int:
        """The start of the span over the swarm's weakest blocks."""
        if throughputs is None:
            uids = module_uids(self.dht_prefix, range(self.cfg.num_hidden_layers))
            infos, _ = await get_remote_module_infos(self.dht, uids)
            throughputs = compute_throughputs(infos, exclude_peer=self.dht.peer_id)
        return choose_best_start(np.asarray(throughputs), self.num_blocks)

    async def _balance_loop(self) -> None:
        """Every ``mean_balance_check_period`` (times 0.5 to 1.5), move the
        span when the swarm would gain (petals_tpu/server/server.py:1034). A
        failed check is logged and the loop goes on."""
        uids = module_uids(self.dht_prefix, range(self.cfg.num_hidden_layers))
        while True:
            await asyncio.sleep(self.mean_balance_check_period * (0.5 + random.random()))
            try:
                infos, _ = await get_remote_module_infos(self.dht, uids)
                if should_choose_other_blocks(
                    self.dht.peer_id, infos, self.num_blocks, balance_quality=self.balance_quality
                ):
                    throughputs = compute_throughputs(infos, exclude_peer=self.dht.peer_id)
                    new_start = await self._choose_start_block(throughputs)
                    if new_start != self.first_block:
                        logger.info(f"Rebalancing: moving the span to start at block {new_start}")
                        await self._reload_span(new_start)
            except Exception as e:
                logger.warning(f"Balance check failed: {e!r}")

    async def resize(self, new_first_block: int) -> bool:
        """The autoscaler's actuator: move the span (of the same length) to
        start at ``new_first_block``, its live sessions pushed to replicas
        first. False when it is there already; an out-of-range target
        raises ValueError, so a bad decision fails loudly rather than
        announcing blocks that do not exist."""
        last = self.cfg.num_hidden_layers - self.num_blocks
        if not 0 <= new_first_block <= last:
            raise ValueError(f"resize target {new_first_block} outside [0, {last}]")
        if new_first_block == self.first_block:
            return False
        logger.info(f"Resize: moving the span to start at block {new_first_block}")
        await self._reload_span(new_first_block)
        return True

    async def _reload_span(self, new_first_block: int) -> None:
        """Move to a new span: OFFLINE on the old blocks, JOINING on the new
        ones, the live sessions parked and pushed to replicas of the old
        span, the new span loaded off the loop, the handler given a new
        backend and pool (whose step programs are captured before it
        returns), then ONLINE. Private sessions keep the old backend until
        they close; the pooled ones were pushed or fail over."""
        try:
            await declare_active_modules(
                self.dht, self.module_uids, self._server_info(ServerState.OFFLINE), self._offline_expiration(),
                contact_addr=self._contact_addr,
            )
        except Exception as e:  # best effort: stale records expire
            logger.debug(f"OFFLINE announce before the span move failed: {e!r}")
        self.first_block = new_first_block
        self.module_uids = module_uids(self.dht_prefix, range(self.first_block, self.first_block + self.num_blocks))
        self._state = ServerState.JOINING  # the announce loop must not say ONLINE yet
        await self._announce(ServerState.JOINING)
        try:
            # before the old pool closes: the sessions' KV goes to replicas
            # of the old span, and the clients adopt it there
            if await self.handler.park_sessions(ttl=60.0):
                await self._migrate_parked_sessions()
        except Exception as e:
            logger.warning(f"Span-move migration failed (the sessions will replay): {e!r}")
        self.backend = self._build_backend(
            await asyncio.to_thread(self._load_span_params, self.first_block, self.num_blocks)
        )
        t0 = time.perf_counter()
        await self.handler.swap_backend(self.backend, self._make_batcher(self.backend))
        self.load_stats["warm_s"] = time.perf_counter() - t0
        await self._warm_self_probe()
        # measured for the old span's successor: the loop measures again
        self._next_pings = {}
        self._state = ServerState.ONLINE
        await self._announce(ServerState.ONLINE)

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
        candidates = sample_up_to(candidates, MAX_PINGED_SUCCESSORS)
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
