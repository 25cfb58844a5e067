"""chip_smoke.py's phase 23 (Gemma, Gemma-2 and Phi-3) alone, on one NVIDIA
GPU:

    python3 scripts/smoke_gemma_phi3.py [kernels]

Builds the CUDA kernels, then runs ``check_gemma_phi3_kernels`` (K1, K2,
K3's int8 and nf4a arms and K4 at head_dim 256 and 96 and with Gemma-2's
softcap, at Gemma-7B's, Gemma-2B's, Gemma-2-9B's and Phi-3-mini's heads)
and, unless ``kernels`` is given, ``serve_gemma_phi3_and_check`` (each
family's span served at its published widths and driven through the port's
client, Gemma-2-9B again at --quant_type nf4a and on an nf4a pool, the
stateless forward at eight Gemma-2-9B lengths, with its graph count, and at
two Phi-3 lengths, each held to the dense references), with the same checks
and prints as the full smoke. The card's name and power limit are printed
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
        print("smoke_gemma_phi3: no CUDA device available", file=sys.stderr)
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
    timer = smoke.Timer(device)
    smoke.log({"gemma_phi3": smoke.check_gemma_phi3_kernels(device, timer)})
    if sys.argv[1:] != ["kernels"]:
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as root:
            smoke.log({"gemma_phi3_launches": smoke.serve_gemma_phi3_and_check(root, device, smi)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
