"""chip_smoke.py's phase 18 (preemption to host memory, qint8 replies and
the relay) alone, on one NVIDIA GPU:

    python3 scripts/smoke_swap_wire.py ["bf16"] ["--kv_quant_type nf4a"] ["relay"]

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint, then runs each named part (default: all
three): ``serve_swap_and_check`` for each run of ``SWAP_RUNS`` named (the
bf16 run also holds the qint8 session), and ``serve_relay_and_check``, with
the same checks and prints as the full smoke. The card's name and power
limit are printed first. Exits non-zero on any failure.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("smoke_swap_wire: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    smoke.log(smi)
    names = sys.argv[1:] or [what for what, *_ in smoke.SWAP_RUNS] + ["relay"]
    # the servers measure their throughput at start and cache it here
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(REPO, "build", "throughput-cache"))
    smoke.build()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        for what, n_blocks, args, wire in smoke.SWAP_RUNS:
            if what in names:
                smoke.serve_swap_and_check(ckpt, device, smi, f"swap ({what}, {n_blocks} blocks)", n_blocks, args,
                                           wire)
                smoke.free_card()
        if "relay" in names:
            smoke.serve_relay_and_check(ckpt, device, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
