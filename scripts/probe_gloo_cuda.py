"""Which gloo collectives take CUDA tensors in this PyTorch: two processes
on one card join a gloo group and try all_reduce, all_gather, broadcast
and point-to-point send / recv on CUDA tensors, each checked against the
right answer, each in a pair of processes of its own (a collective that
gloo cannot run on device memory may abort its process). Prints the card's
name and power limit (nvidia-smi), one JSON line per collective, and the
list of those that worked.

    python3 scripts/probe_gloo_cuda.py

parallel/collectives.py ``GLOO_CUDA_NATIVE`` names the collectives this
found to take CUDA tensors; the rest are staged through host memory.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys


OPS = ("all_reduce", "all_gather", "broadcast", "send_recv", "all_reduce_bf16")


def child(op: str, rank: int, port: int) -> None:
    """One collective on CUDA tensors in a gloo group of two: prints
    "ok" / "wrong" / "refused: ..." (a Python exception). A collective that
    gloo cannot run on device memory may also abort the process; the parent
    reports that from the exit code."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)

    def all_reduce():
        t = torch.full((1024,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == 3.0).all())

    def all_gather():
        parts = [torch.empty(1024, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((1024,), float(rank), device=dev))
        return bool((parts[0] == 0).all() and (parts[1] == 1).all())

    def broadcast():
        t = torch.full((1024,), float(rank + 5), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 5.0).all())

    def send_recv():
        mine, other = torch.full((1024,), float(rank), device=dev), torch.empty(1024, device=dev)
        works = [dist.isend(mine, 1 - rank), dist.irecv(other, 1 - rank)]
        for w in works:
            w.wait()
        return bool((other == 1 - rank).all())

    def all_reduce_bf16():
        t = torch.full((1024,), float(rank + 1), device=dev, dtype=torch.bfloat16)
        dist.all_reduce(t)
        return bool((t == 3.0).all())

    fn = dict(all_reduce=all_reduce, all_gather=all_gather, broadcast=broadcast, send_recv=send_recv,
              all_reduce_bf16=all_reduce_bf16)[op]
    try:
        out = "ok" if fn() else "wrong"
    except Exception as e:  # the collective refused the CUDA tensor
        out = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    print(json.dumps({"op": op, "rank": rank, "result": out}), flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if len(sys.argv) == 4:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
        return 0
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    summary = {}
    for op in OPS:  # each collective in a pair of its own: an abort takes only that pair down
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), op, str(r), str(port)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=120)
                outs.append((p.returncode, out.strip(), err.strip().splitlines()[-1:] if err.strip() else []))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        results = [json.loads(o)["result"] if rc == 0 and o else f"aborted (exit {rc}): {e}" for rc, o, e in outs]
        summary[op] = results[0] if len(set(results)) == 1 else results
        print(json.dumps({"op": op, "result": summary[op]}), flush=True)
    native = sorted(op for op, r in summary.items() if r == "ok")
    print(json.dumps({"gloo_cuda_native": native}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
