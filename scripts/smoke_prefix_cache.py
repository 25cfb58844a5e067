"""chip_smoke.py's phase 17 (the prefix cache) alone, on one NVIDIA GPU:

    python3 scripts/smoke_prefix_cache.py ["bf16"] ["--kv_quant_type nf4a"] ["--page_size 0"] ["private sessions"]

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint, then runs ``serve_prefix_and_check`` for each
run of ``PREFIX_RUNS`` named (default: all four), with the same checks and
prints as the full smoke. The card's name and power limit are printed
first. Exits non-zero on any failure.
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
        print("smoke_prefix_cache: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    smoke.log(smi)
    # the servers measure their throughput at start and cache it here
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(REPO, "build", "throughput-cache"))
    smoke.build()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        smoke.serve_prefix_runs(ckpt, device, smi, sys.argv[1:] or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
