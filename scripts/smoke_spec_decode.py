"""chip_smoke.py's phase 20 (server-side speculative decoding) alone, on
one NVIDIA GPU:

    python3 scripts/smoke_spec_decode.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint, then runs ``serve_spec_and_check``: a
cooperative draft on the 8-layer cut (K1's k+1-row arm in the verify step),
an nf4a self-draft on a 2-layer cut with an nf4a pool (K3's nf4a arm, K5 in
the draft), each beside the same sessions with the draft detached, the
verify step's profile and the verify arm's kernel times, with the same
checks and prints as the full smoke. The card's name and power limit are
printed first. Exits non-zero on any failure.
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
        print("smoke_spec_decode: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    smoke.log(smi)
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(REPO, "build", "throughput-cache"))
    smoke.build()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        smoke.serve_spec_and_check(ckpt, device, smi, smoke.Timer(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
