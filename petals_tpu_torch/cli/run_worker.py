"""Multi-host serving worker: the non-leader half of a span server whose
tensor (and sequence) parallelism spans several processes
(parallel/multihost.py; the port of petals_tpu/cli/run_worker.py).

Start ONE leader (``run_server`` with --coordinator_address/--num_hosts)
and ``num_hosts - 1`` workers, each with the SAME model/span/quant/dtype
flags:

    # process 0 (leader: DHT + RPC + scheduler)
    python -m petals_tpu_torch.cli.run_server MODEL --first_block 0 --num_blocks 8 \\
        --coordinator_address host0:8476 --num_hosts 2 --num_tp_devices 2 --throughput 100

    # process 1 (worker: lockstep compute replica)
    python -m petals_tpu_torch.cli.run_worker MODEL --first_block 0 --num_blocks 8 \\
        --coordinator_address host0:8476 --num_hosts 2 --host_index 1 --num_tp_devices 2

The worker joins the ``torch.distributed`` group, builds the identical
backend from the identical checkpoint through the port's loaders (its
shards of the global grid, on ``--device``: the current CUDA device by
default, a comma-separated list for several; ``cpu`` runs it on the CPU),
and executes the leader's broadcast ops until the leader shuts down. Two
processes may share one card: the data group then runs on gloo. With
``PETALS_TPU_WORKER_COUNTS`` set to a path, the worker writes its kernel
launch counts there after every op, as one JSON object ``{"ops": n,
"launches": {...}}``: n is the number of op headers it has received, so a
reader that knows how many the leader sent knows whether the counts are
final.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

from petals_tpu_torch.utils.convert_block import QuantType

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("model", help="model path or repo id (must match the leader's)")
    parser.add_argument("--coordinator_address", required=True)
    parser.add_argument("--num_hosts", type=int, required=True)
    parser.add_argument("--host_index", type=int, required=True, help="this worker's process id (1..num_hosts-1)")
    parser.add_argument("--first_block", type=int, required=True)
    parser.add_argument("--num_blocks", type=int, required=True)
    parser.add_argument("--num_tp_devices", type=int, default=None,
                        help="global tp width (default: every device in the group / sp)")
    parser.add_argument("--num_sp_devices", type=int, default=None,
                        help="sequence-parallel width — MUST match the leader's flag")
    parser.add_argument("--quant_type", default="none", choices=[q.value for q in QuantType])
    parser.add_argument("--torch_dtype", "--dtype", dest="dtype", default="bfloat16", choices=sorted(DTYPES))
    parser.add_argument("--max_chunk_size_bytes", type=int, default=256 * 1024 * 1024)
    parser.add_argument("--adapters", nargs="*", default=(),
                        help="PEFT checkpoint dirs — MUST match the leader's --adapters")
    parser.add_argument("--revision", default="main")
    parser.add_argument("--cache_dir", default=None)
    parser.add_argument("--no_quant_weight_cache", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the current CUDA device); a comma-separated list names "
                             "this process's devices of the grid")
    return parser


def launch_counts() -> dict:
    """This process's kernel launches so far: K4, and K5 / K6 by phase and
    kind ("<decode|prefill> <kind>")."""
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import quant_matmul as qmm

    out = {"K4": int(fa.flash_attend.launches)}
    for phase, fn in (("decode", qmm.quant_decode_matmul), ("prefill", qmm.quant_prefill_matmul)):
        out.update({f"{phase} {kind}": int(n) for kind, n in fn.launches.items()})
    return out


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    if not 1 <= args.host_index:
        raise SystemExit("--host_index must be >= 1 (process 0 is the run_server leader)")

    from petals_tpu_torch.parallel.multihost import LockstepWorker, init_multihost, multihost_layout, ops_broadcast
    from petals_tpu_torch.server.backend import TransformerBackend
    from petals_tpu_torch.server.from_pretrained import get_block_config
    from petals_tpu_torch.server.server import load_converted_block
    from petals_tpu_torch.utils.device import resolve_device

    logger = logging.getLogger("petals_tpu_torch.cli.run_worker")
    devices = [resolve_device(d) for d in args.device.split(",")] if args.device else [resolve_device(None)]
    init_multihost(args.coordinator_address, args.num_hosts, args.host_index, devices=devices)
    layout, local = multihost_layout(args.num_tp_devices, args.num_sp_devices or 1)
    dtype = DTYPES[args.dtype]
    family, cfg = get_block_config(args.model, revision=args.revision, cache_dir=args.cache_dir)
    if local[0].type == "cuda":
        # load the kernels this span launches before the first op, as the
        # leader's server does (built already where the leader built them)
        from petals_tpu_torch.ops import flash_attention, grouped_matmul, quant_matmul

        flash_attention.kernel_library()
        if args.quant_type != QuantType.NONE.value:
            quant_matmul.kernel_library()
        if family.block_arch == "mixtral":
            grouped_matmul.kernel_library()

    def build_backend(first_block: int) -> TransformerBackend:
        """The first build AND the live-span-move rebuild (OP_RELOAD_SPAN):
        the leader's loading (unfused, this process's shards), adapters
        re-sliced for the new span as the leader's reload does."""
        from petals_tpu_torch.parallel.sp import replicate_over_sp
        from petals_tpu_torch.parallel.tp import shard_span_params

        blocks = []
        for i in range(first_block, first_block + args.num_blocks):
            block = load_converted_block(
                args.model, i, family=family, cfg=cfg, quant_type=args.quant_type, fuse=False, compute_dtype=dtype,
                device=local[0], revision=args.revision, cache_dir=args.cache_dir,
                quant_weight_cache=not args.no_quant_weight_cache,
            )
            shards = shard_span_params([block], local[:: layout.n_s], family.name, cfg, n_shards=layout.tp,
                                       first=layout.t0)[0]
            blocks.append(replicate_over_sp(shards, local, layout.n_s) if layout.n_s > 1 else shards)
        backend = TransformerBackend(
            family, cfg, blocks, first_block=first_block, n_blocks=args.num_blocks, device=local[0],
            compute_dtype=dtype, max_chunk_size_bytes=args.max_chunk_size_bytes, quant_type=args.quant_type,
            tp_devices=local, num_sp_devices=layout.n_s, layout=layout,
        )
        if args.adapters:
            from petals_tpu_torch.utils.peft import load_adapter, stack_adapter

            block_range = range(first_block, first_block + args.num_blocks)
            for path in args.adapters:
                adapter = load_adapter(path, family.name, block_range=block_range)
                per_block = stack_adapter(adapter, first_block, args.num_blocks, dtype, local[0])
                backend.adapters[adapter.name] = (per_block, adapter.scaling)
            logger.info(f"worker hosting adapters: {sorted(backend.adapters)}")
        return backend

    t_load = time.perf_counter()
    backend = build_backend(args.first_block)
    logger.info(
        f"worker {args.host_index}/{args.num_hosts}: span [{args.first_block}, {args.first_block + args.num_blocks}) "
        f"over tp={layout.tp} x sp={layout.sp}, shards [{layout.t0}, {layout.t0 + layout.n_t}) x ranks "
        f"[{layout.s0}, {layout.s0 + layout.n_s}) on {','.join(map(str, local))}, loaded in "
        f"{time.perf_counter() - t_load:.1f} s"
    )
    counts_path = os.environ.get("PETALS_TPU_WORKER_COUNTS")

    def after_op() -> None:
        with open(counts_path + ".tmp", "w") as f:
            json.dump({"ops": ops_broadcast(), "launches": launch_counts()}, f)
        os.replace(counts_path + ".tmp", counts_path)

    LockstepWorker(backend, rebuild_fn=build_backend, after_op=after_op if counts_path else None).run()


if __name__ == "__main__":
    main()
