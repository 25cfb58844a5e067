"""Serve a span of a local checkpoint on the CUDA card:

    python -m petals_tpu_torch.cli.run_server <checkpoint dir> --first_block 0 --num_blocks 8

The defaults are petals_tpu's: bf16, ``--page_size 64``,
``--prefill_token_budget 512``, an 8192-token KV budget. The span is
required: there is no DHT to place it by.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

import torch

from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.server import Server

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Host a span of transformer blocks on this CUDA card")
    parser.add_argument("model", help="Local path of the HF checkpoint to serve")
    parser.add_argument("--first_block", type=int, required=True, help="First block to serve")
    parser.add_argument("--num_blocks", type=int, required=True, help="How many blocks to serve")
    parser.add_argument("--host", default="0.0.0.0", help="Listen address")
    parser.add_argument("--port", type=int, default=0, help="Listen port (0 = ephemeral)")
    parser.add_argument("--dht_prefix", default=None, help="Swarm namespace (default: derived from model name)")
    parser.add_argument("--device", default=None, help="torch device (default: the current CUDA device)")
    parser.add_argument("--torch_dtype", "--dtype", dest="dtype", default="bfloat16",
                        choices=sorted(DTYPES), help="Compute dtype")
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
    parser.add_argument("--page_size", type=int, default=64, help="Paged KV cache: tokens per page")
    parser.add_argument("--n_pages", type=int, default=None,
                        help="Paged KV pool size in pages (default: batch_lanes * pages-per-lane)")
    parser.add_argument("--prefill_token_budget", type=int, default=512,
                        help="Max prefill-chunk tokens folded into each mixed batched step "
                             "(halved under decode pressure)")
    return parser


def attn_cache_bytes_for(args: argparse.Namespace) -> int:
    """``--attn_cache_tokens`` in bytes for the span, as petals_tpu's CLI
    converts it."""
    _, cfg = get_block_config(args.model)
    return (
        2 * args.attn_cache_tokens * cfg.num_key_value_heads * cfg.head_dim
        * DTYPES[args.dtype].itemsize * args.num_blocks
    )


def build_server(args: argparse.Namespace) -> Server:
    return Server(
        args.model,
        first_block=args.first_block,
        num_blocks=args.num_blocks,
        dht_prefix=args.dht_prefix,
        host=args.host,
        port=args.port,
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
    )


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    server = build_server(args)

    async def run():
        await server.start()
        print(f"listening on {server.host}:{server.rpc_server.port}", flush=True)
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
