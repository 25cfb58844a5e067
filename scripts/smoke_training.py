"""chip_smoke.py's phase 24 (training and adapters) alone, on one NVIDIA GPU:

    python3 scripts/smoke_training.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint, then runs ``serve_training_and_check``:
``ptu.backward`` from the port's client on the 8-block bf16 span (its
gradients held to a float32 autograd reference, its wall, device busy, peak
memory and the shares of the dequant-transpose and the attention backward),
the port's client training deep prompts over it and one classification
step, the backward on 2-block nf4a and int8 spans (K5 / K6 launched inside
it), and two seeded PEFT adapters served with ``--adapters`` in bf16 and
nf4a (forward, backward and a greedy session held to the merged-weight
references, no capture after switching adapters), with the same checks and
prints as the full smoke. The card's name and power limit are printed
first. Exits non-zero on any failure.
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
        print("smoke_training: no CUDA device available", file=sys.stderr)
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
        result = smoke.serve_training_and_check(ckpt, device, smi)
    smoke.log(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
