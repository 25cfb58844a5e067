"""chip_smoke.py's phase 21 (the stateless forward, the integrity probe and
the telemetry plane) alone, on one NVIDIA GPU:

    python3 scripts/smoke_forward_telemetry.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint, then runs ``serve_forward_telemetry_and_check``:
``ptu.forward`` from the port's client on bf16 weights (K4 on every block)
and on an nf4a sub-span chain (K5's prefill kernel), the forward programs'
growth over distinct lengths, ``ptu.probe`` with its digest gaps beside
``tolerance_for("none")``, fused fingerprints on chip_smoke.py's phase-3
sessions with their device cost, and the telemetry plane (``/metrics``,
``/journal``, the announce, a ``--trace_dir`` capture naming K4's kernel),
with the same checks and prints as the full smoke. The card's name and
power limit are printed first. Exits non-zero on any failure.
"""

from __future__ import annotations

import json
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
        print("smoke_forward_telemetry: no CUDA device available", file=sys.stderr)
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
        result = smoke.serve_forward_telemetry_and_check(ckpt, device, smi)
    smoke.log(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
