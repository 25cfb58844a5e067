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
and an 8192-token KV budget (in floating-point bytes, whatever the pool's
encoding, as petals_tpu converts it).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

import torch

from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.utils.convert_block import QuantType

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
    parser.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
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
    parser.add_argument("--attn_cache_tokens", type=int, default=8192,
                        help="KV-cache budget in tokens (converted to bytes for the allocator)")
    parser.add_argument("--max_chunk_size_bytes", type=int, default=256 * 1024 * 1024,
                        help="Prefill chunking bound (activation bytes per chunk)")
    parser.add_argument("--max_alloc_timeout", type=float, default=600.0)
    parser.add_argument("--compression", default="none", choices=["none", "float16", "bfloat16"],
                        help="Default reply compression (clients may override per request)")
    parser.add_argument("--inference_max_length", type=int, default=None,
                        help="Reject sessions longer than this (default: 8192 for GQA/MQA "
                             "models, 2048 otherwise)")
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
    parser.add_argument("--no_server_side_generation", action="store_true",
                        help="Do not generate tokens on the server (a whole-model span otherwise "
                             "loads the client's leaves and answers gen_tokens)")
    parser.add_argument("--prefix_cache_bytes", type=int, default=256 * 2**20,
                        help="Host-RAM prompt-prefix cache budget; 0 disables")
    parser.add_argument("--prefix_device_bytes", type=int, default=256 * 2**20,
                        help="HBM tier of the prefix cache (device-resident hit seeding); 0 disables")
    parser.add_argument("--prefix_cache_policy", choices=["radix", "lru"], default="radix",
                        help="'radix' keys prefix-cache entries into a token-segment radix "
                             "tree with tiered residency (HBM / host) and leaf-first eviction; "
                             "'lru' is the flat insertion-order baseline (A/B comparisons)")
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
    _, cfg = get_block_config(args.model)
    return (
        2 * args.attn_cache_tokens * cfg.num_key_value_heads * cfg.head_dim
        * DTYPES[args.dtype].itemsize * (parse_block_range(args)[1] or cfg.num_hidden_layers)
    )


def build_server(args: argparse.Namespace) -> Server:
    first_block, num_blocks = parse_block_range(args)
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
        device=args.device,
        compute_dtype=DTYPES[args.dtype],
        attn_cache_bytes=attn_cache_bytes_for(args),
        max_chunk_size_bytes=args.max_chunk_size_bytes,
        max_alloc_timeout=args.max_alloc_timeout,
        compression=args.compression,
        inference_max_length=args.inference_max_length,
        session_timeout=args.session_timeout,
        step_timeout=args.step_timeout,
        batch_lanes=args.batch_lanes,
        batch_max_length=args.batch_max_length,
        page_size=args.page_size,
        n_pages=args.n_pages,
        prefill_token_budget=args.prefill_token_budget,
        quant_type=args.quant_type,
        kv_quant_type=args.kv_quant_type,
        server_side_generation=not args.no_server_side_generation,
        prefix_cache_bytes=args.prefix_cache_bytes,
        prefix_device_bytes=args.prefix_device_bytes,
        prefix_cache_policy=args.prefix_cache_policy,
        prefix_share_scope=args.prefix_share_scope,
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    server = build_server(args)

    async def run():
        await server.start()
        print(server.contact_addr.to_string(), flush=True)  # the address peers dial
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        try:
            await stop.wait()
        finally:
            await server.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
