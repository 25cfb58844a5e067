"""Serve a span of a local checkpoint on the CUDA card, in a petals_tpu
swarm:

    python -m petals_tpu_torch.cli.run_dht                  # prints its address
    python -m petals_tpu_torch.cli.run_server <checkpoint dir> --initial_peers <address>

Without ``--first_block`` the server places its span where the swarm is
weakest, and without ``--num_blocks`` it serves as many blocks as fit the
card beside the KV budget; ``--block_indices 0:16`` gives both at once.
Without ``--initial_peers`` it starts a swarm of its own. The defaults are
petals_tpu's: bf16, ``--quant_type none``, ``--kv_quant_type none``,
``--page_size 64``, ``--prefill_token_budget 512``, ``--throughput auto``
(measured on the card, server/throughput.py, and cached under
``$PETALS_TPU_TORCH_CACHE``, default ~/.cache/petals_tpu_torch), an
announce every 30 seconds, server-side generation on a whole-model span
(``--no_server_side_generation`` turns it off), the prompt-prefix cache
(``--prefix_cache_bytes`` and ``--prefix_device_bytes`` 256 MiB each,
``--prefix_cache_policy radix``, ``--prefix_share_scope swarm``),
no swap tier (``--swap_host_bytes 0``; with a budget, an exhausted page pool
preempts an idle session to host memory, ``--preemption_policy lru``),
and an 8192-token KV budget (in floating-point bytes, whatever the pool's
encoding, as petals_tpu converts it). A server behind NAT passes
``--relay_via host:port`` (the relay a port or petals_tpu bootstrap prints):
it then listens nowhere and serves through reverse connections the relay
splices. ``--drain_seconds N`` makes the first SIGTERM/SIGINT park the live
sessions' KV, push it to replicas and keep serving exports for N seconds
before exiting (a second signal skips the rest); ``--phase_tier`` announces
the server as a prefill or decode specialist (default: generalist).
``--draft_model <small checkpoint dir>`` turns on speculative decoding on a
whole-model span: the draft proposes ``--spec_k`` (4) tokens a generating
lane a tick from its last ``--draft_window`` (64) tokens, its blocks
quantized per ``--draft_quant_type`` (nf4a), and the span verifies them in
one paged step; the tokens are plain decode's.
``--metrics_port N`` serves ``/metrics``, ``/journal`` and ``/ledger`` on a
local HTTP port (0: ephemeral), ``--trace_dir DIR`` writes a torch.profiler
Chrome trace of the first ``PETALS_TPU_TRACE_SECONDS`` (60) of serving, and
``--request_timeout`` (180 s) bounds a stateless forward, backward or
probe. ``--adapters DIR ...`` hosts PEFT LoRA adapters (loaded for the
span, announced by name; requests pick one with ``active_adapter``).
``--mean_balance_check_period S`` moves the span when the swarm's quality
falls under ``--balance_quality`` (0.75), its live sessions pushed to
replicas first; ``--no_batching`` serves every session from a private
cache, with no lane pool. A quantized span is kept in the disk cache of
quantized blocks (``--cache_dir``, default ``$PETALS_TPU_TORCH_CACHE``;
``--no_quant_weight_cache`` turns it off), which the next start reads.
``--num_tp_devices N`` splits the span over the first N CUDA devices of
the host, tensor parallel in this one process (the dense lane pool; no
``--kv_quant_type``, no ``+o`` kinds); ``--num_sp_devices M`` adds M
sequence-parallel ranks over the next devices (tp x sp of them, grid
order: ring attention on the stateless forward and backward, query-sharded
cached prefill; not for Gemma-2). ``--num_hosts H
--coordinator_address host:port`` makes this process the leader of a
multi-host span over H processes (``python -m
petals_tpu_torch.cli.run_worker`` runs the others, with the same model,
span, quantization and dtype): the grid lies over every process's devices
(``--device``, a comma-separated list for several), and the span must be
given. A
model that is no local directory is a Hub repo id, streamed at
``--revision`` from ``PETALS_TPU_HUB_ENDPOINT`` (or ``HF_ENDPOINT``) with
``--token``, only the span's shards, under ``--max_disk_space`` (LRU).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

import torch

from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.models.registry import num_kv_heads
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.utils.convert_block import QuantType
from petals_tpu_torch.utils.hub import parse_size

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Host a span of transformer blocks on this CUDA card")
    parser.add_argument("model", help="Local path of the HF checkpoint to serve")
    parser.add_argument("--host", default="0.0.0.0", help="Listen address")
    parser.add_argument("--port", type=int, default=0, help="Listen port (0 = ephemeral)")
    parser.add_argument("--initial_peers", nargs="*", default=[],
                        help="Bootstrap peers as host:port/peer_id strings (none: a swarm of one)")
    parser.add_argument("--identity_seed", default=None,
                        help="Seed string for a deterministic peer id")
    parser.add_argument("--first_block", type=int, default=None,
                        help="First block to serve (default: placed where the swarm is weakest)")
    parser.add_argument("--num_blocks", type=int, default=None,
                        help="How many blocks to serve (default: as many as fit the card)")
    parser.add_argument("--block_indices", default=None,
                        help="Alternative to first/num: a range like 0:16")
    parser.add_argument("--throughput", default="auto",
                        help='"auto" to measure it on the card, or a number (requests a second)')
    parser.add_argument("--update_period", type=float, default=30.0, help="DHT announce period, seconds")
    parser.add_argument("--public_name", default=None, help="Display name announced to the swarm")
    parser.add_argument("--network_mbps", type=float, default=None,
                        help="Known network budget in Mbit/s (default: probe the bootstrap peers; "
                             "the loopback stack probe when alone)")
    parser.add_argument("--dht_prefix", default=None, help="Swarm namespace (default: derived from model name)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device); a comma-separated list "
                             "names this process's devices of a tp x sp grid")
    parser.add_argument("--torch_dtype", "--dtype", dest="dtype", default="bfloat16",
                        choices=sorted(DTYPES), help="Compute dtype")
    parser.add_argument("--quant_type", default="none", choices=[q.value for q in QuantType],
                        help="Weight quantization: int8 (per-channel), nf4 / nf4a / int4 (blockwise "
                             "4-bit; nf4a is the 4-bit serving default), +o = keep in/64 outlier "
                             "input channels dense")
    parser.add_argument("--kv_quant_type", default="none", choices=["none", "int8", "nf4a"],
                        help="Quantize the paged KV pool in place: int8 (per-row absmax) or packed "
                             "nf4a; the same cache budget then holds about 2x or 4x the pages, and "
                             "attention decodes the pages inside its kernels")
    parser.add_argument("--num_tp_devices", type=int, default=None,
                        help="Tensor-parallel over this many of the host's CUDA devices (one process)")
    parser.add_argument("--num_sp_devices", type=int, default=None,
                        help=">1: sequence parallel over this many ranks (ring attention on the "
                             "stateless forward/backward, query-sharded cached prefill), tp x sp devices")
    parser.add_argument("--coordinator_address", default=None,
                        help="multi-host serving: the group's rendezvous (host:port) for torch.distributed; "
                             "start num_hosts-1 run_worker processes with the same flags")
    parser.add_argument("--num_hosts", type=int, default=1,
                        help="multi-host serving: total processes incl. this leader")
    parser.add_argument("--adapters", nargs="*", default=[],
                        help="PEFT adapter checkpoint dirs to host (multi-tenant LoRA); requests "
                             "pick one by name with active_adapter")
    parser.add_argument("--attn_cache_tokens", type=int, default=8192,
                        help="KV-cache budget in tokens (converted to bytes for the allocator)")
    parser.add_argument("--max_chunk_size_bytes", type=int, default=256 * 1024 * 1024,
                        help="Prefill chunking bound (activation bytes per chunk)")
    parser.add_argument("--max_alloc_timeout", type=float, default=600.0)
    parser.add_argument("--compression", default="none", choices=["none", "float16", "bfloat16", "qint8"],
                        help="Default reply compression (clients may override per request)")
    parser.add_argument("--relay_via", default=None,
                        help="host:port of a relay peer (run_dht prints one): serve from behind "
                             "NAT/firewall with no inbound listener (rpc/relay.py)")
    parser.add_argument("--trace_dir", default=None,
                        help="Capture a torch.profiler trace (CPU and CUDA activity, Chrome trace JSON) "
                             "here for PETALS_TPU_TRACE_SECONDS (default 60) from startup "
                             "(or set PETALS_TPU_TRACE_DIR)")
    parser.add_argument("--metrics_port", type=int, default=None,
                        help="Serve Prometheus-text /metrics (plus the /journal scheduler event log and "
                             "the /ledger view) on this local HTTP port; 0 = ephemeral, omit to disable")
    parser.add_argument("--drain_seconds", type=float, default=0.0,
                        help="On SIGTERM/SIGINT, park live sessions' KV and keep serving "
                             "ptu.session_export for this long before exiting, so clients "
                             "migrate caches to replacements instead of recomputing prefills")
    parser.add_argument("--inference_max_length", type=int, default=None,
                        help="Reject sessions longer than this (default: 8192 for GQA/MQA "
                             "models, 2048 otherwise)")
    parser.add_argument("--request_timeout", type=float, default=3 * 60,
                        help="Timeout for a stateless forward or an integrity probe, seconds")
    parser.add_argument("--session_timeout", type=float, default=30 * 60,
                        help="Max idle time of an inference session, seconds")
    parser.add_argument("--step_timeout", type=float, default=5 * 60,
                        help="Timeout for one inference step, seconds")
    parser.add_argument("--batch_lanes", type=int, default=None,
                        help="Lane count (default: auto-size to the cache budget, <=8)")
    parser.add_argument("--batch_max_length", type=int, default=None,
                        help="Lane length in tokens (default: min(inference_max_length, 1024))")
    parser.add_argument("--page_size", type=int, default=64,
                        help="Paged KV cache: tokens per page; 0 selects the dense lane pool")
    parser.add_argument("--n_pages", type=int, default=None,
                        help="Paged KV pool size in pages (default: batch_lanes * pages-per-lane)")
    parser.add_argument("--prefill_token_budget", type=int, default=512,
                        help="Max prefill-chunk tokens folded into each mixed batched step "
                             "(halved under decode pressure)")
    parser.add_argument("--draft_model", default=None,
                        help="Local path of a SMALL checkpoint for speculative decoding: "
                             "it drafts --spec_k tokens per lane per tick and the span "
                             "verifies them in one paged step (full-span single-host "
                             "servers with server-side generation and a paged pool; "
                             "output stays bit-identical to plain decode)")
    parser.add_argument("--spec_k", type=int, default=4,
                        help="Draft tokens verified per lane per tick (with --draft_model)")
    parser.add_argument("--draft_window", type=int, default=None,
                        help="Draft context window in tokens (default 64): the draft "
                             "re-prefills the last N tokens each tick")
    parser.add_argument("--draft_quant_type", default="nf4a",
                        choices=["none", "int8", "nf4", "nf4a", "int4"],
                        help="Quantization for the draft model's blocks")
    parser.add_argument("--no_server_side_generation", action="store_true",
                        help="Do not generate tokens on the server (a whole-model span otherwise "
                             "loads the client's leaves and answers gen_tokens)")
    parser.add_argument("--swap_host_bytes", type=int, default=0,
                        help="Host-RAM KV swap tier for session preemption (paged lanes only): "
                             "on pool exhaustion an idle victim session's pages are copied to "
                             "host RAM and freed, then transparently swapped back in on its "
                             "next step; 0 disables (full pool keeps the fail-at-timeout "
                             "backpressure behavior)")
    parser.add_argument("--preemption_policy", choices=["lru", "largest", "off"], default="lru",
                        help="Victim choice on pool exhaustion: 'lru' = lowest priority class "
                             "then least-recently-stepped; 'largest' = lowest class then most "
                             "pages held; 'off' disables preemption")
    parser.add_argument("--prefix_cache_bytes", type=int, default=256 * 2**20,
                        help="Host-RAM prompt-prefix cache budget; 0 disables")
    parser.add_argument("--prefix_device_bytes", type=int, default=256 * 2**20,
                        help="HBM tier of the prefix cache (device-resident hit seeding); 0 disables")
    parser.add_argument("--prefix_cache_policy", choices=["radix", "lru"], default="radix",
                        help="'radix' keys prefix-cache entries into a token-segment radix "
                             "tree with tiered residency (HBM / host) and leaf-first eviction; "
                             "'lru' is the flat insertion-order baseline (A/B comparisons)")
    parser.add_argument("--phase_tier", choices=["generalist", "prefill", "decode"], default="generalist",
                        help="Disaggregated serving tier announced to the swarm: 'prefill' "
                             "replicas soak heavy prompt processing and hand the finished KV "
                             "to a 'decode' replica over the server-to-server page-push path; "
                             "'generalist' (default) serves both phases")
    parser.add_argument("--mean_balance_check_period", type=float, default=0.0,
                        help=">0: periodically consider moving to under-served blocks (seconds)")
    parser.add_argument("--balance_quality", type=float, default=0.75,
                        help="Rebalance only when the swarm's quality falls below this fraction "
                             "of the post-move optimum")
    parser.add_argument("--no_batching", action="store_true",
                        help="Disable continuous batching of concurrent decode sessions")
    parser.add_argument("--no_quant_weight_cache", action="store_true",
                        help="Re-quantize at every start instead of persisting packed "
                             "quantized blocks in the disk cache (utils/quant_cache.py)")
    parser.add_argument("--cache_dir", default=None,
                        help="Hub download and quantized-block cache directory "
                             "(default: $PETALS_TPU_TORCH_CACHE, else ~/.cache/petals_tpu_torch)")
    parser.add_argument("--max_disk_space", default=None,
                        help="Hub/checkpoint cache budget, e.g. 300GB (LRU-evicted)")
    parser.add_argument("--revision", default="main",
                        help="Hub revision (branch/tag/commit) for weight streaming")
    parser.add_argument("--token", default=None,
                        help="HF Hub access token for gated/private repos (or set HF_TOKEN)")
    parser.add_argument("--prefix_share_scope", choices=["swarm", "peer"], default="swarm",
                        help="'swarm' shares cached prefixes across all clients (fastest; a client "
                             "can time-probe whether a prompt prefix was recently served); 'peer' "
                             "salts entries per authenticated client identity, closing that "
                             "side channel at the cost of cross-client sharing")
    return parser


def parse_block_range(args: argparse.Namespace) -> tuple:
    """(first_block, num_blocks) from ``--block_indices`` or the two flags."""
    if args.block_indices:
        first, last = args.block_indices.split(":")
        return int(first), int(last) - int(first)
    return args.first_block, args.num_blocks


def attn_cache_bytes_for(args: argparse.Namespace) -> int:
    """``--attn_cache_tokens`` in bytes for the span (the whole model when
    its size is not given), as petals_tpu's CLI converts it: floating-point
    bytes, whatever ``--kv_quant_type``."""
    _, cfg = get_block_config(args.model, revision=args.revision, cache_dir=args.cache_dir)
    return (
        2 * args.attn_cache_tokens * num_kv_heads(cfg) * cfg.head_dim
        * DTYPES[args.dtype].itemsize * (parse_block_range(args)[1] or cfg.num_hidden_layers)
    )


def build_server(args: argparse.Namespace) -> Server:
    first_block, num_blocks = parse_block_range(args)
    devices = args.device.split(",") if args.device and "," in args.device else None
    try:
        throughput = float(args.throughput)
    except ValueError:
        throughput = args.throughput
    return Server(
        args.model,
        first_block=first_block,
        num_blocks=num_blocks,
        dht_prefix=args.dht_prefix,
        host=args.host,
        port=args.port,
        initial_peers=args.initial_peers,
        identity_seed=args.identity_seed.encode() if args.identity_seed else None,
        throughput=throughput,
        update_period=args.update_period,
        public_name=args.public_name,
        network_mbps=args.network_mbps,
        device=devices[0] if devices else args.device,
        tp_devices=devices,
        num_tp_devices=args.num_tp_devices,
        num_sp_devices=args.num_sp_devices,
        num_hosts=args.num_hosts,
        coordinator_address=args.coordinator_address,
        compute_dtype=DTYPES[args.dtype],
        attn_cache_bytes=attn_cache_bytes_for(args),
        max_chunk_size_bytes=args.max_chunk_size_bytes,
        max_alloc_timeout=args.max_alloc_timeout,
        compression=args.compression,
        relay_via=args.relay_via,
        inference_max_length=args.inference_max_length,
        request_timeout=args.request_timeout,
        session_timeout=args.session_timeout,
        step_timeout=args.step_timeout,
        metrics_port=args.metrics_port,
        trace_dir=args.trace_dir,
        batch_lanes=args.batch_lanes,
        batch_max_length=args.batch_max_length,
        page_size=args.page_size,
        n_pages=args.n_pages,
        prefill_token_budget=args.prefill_token_budget,
        swap_host_bytes=args.swap_host_bytes,
        preemption_policy=args.preemption_policy,
        quant_type=args.quant_type,
        kv_quant_type=args.kv_quant_type,
        server_side_generation=not args.no_server_side_generation,
        prefix_cache_bytes=args.prefix_cache_bytes,
        prefix_device_bytes=args.prefix_device_bytes,
        prefix_cache_policy=args.prefix_cache_policy,
        prefix_share_scope=args.prefix_share_scope,
        phase_tier=args.phase_tier,
        draft_model=args.draft_model,
        spec_k=args.spec_k,
        draft_window=args.draft_window,
        draft_quant_type=args.draft_quant_type,
        adapters=args.adapters,
        mean_balance_check_period=args.mean_balance_check_period,
        balance_quality=args.balance_quality,
        revision=args.revision,
        cache_dir=args.cache_dir,
        quant_weight_cache=not args.no_quant_weight_cache,
        batching=not args.no_batching,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    # the Hub fetcher reads these when it runs
    if args.max_disk_space:
        try:
            parse_size(args.max_disk_space)  # fail fast, with the flag named
        except ValueError:
            build_parser().error(
                f"--max_disk_space: cannot parse {args.max_disk_space!r} (expected e.g. 300GB, 512MB, or bytes)"
            )
        os.environ["PETALS_TPU_MAX_DISK_SPACE"] = args.max_disk_space
    if args.token:
        os.environ["HF_TOKEN"] = args.token
    server = build_server(args)

    async def run():
        await server.start()
        print(server.contact_addr.to_string(), flush=True)  # the address peers dial
        stop, force = asyncio.Event(), asyncio.Event()

        def on_signal():
            # a second signal skips what is left of the drain window
            (force if stop.is_set() else stop).set()

        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, on_signal)
        try:
            await stop.wait()
            if args.drain_seconds > 0:
                parked = await server.drain(park_ttl=args.drain_seconds + 30)
                if parked:
                    logging.getLogger(__name__).info(
                        f"Drain window: serving KV exports for {parked} session(s) for "
                        f"{args.drain_seconds:.0f} s (signal again to skip)"
                    )
                    try:
                        await asyncio.wait_for(force.wait(), args.drain_seconds)
                    except asyncio.TimeoutError:
                        pass
        finally:
            await server.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
