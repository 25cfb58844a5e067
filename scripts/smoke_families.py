"""chip_smoke.py's phase 22 (BLOOM, Falcon and Mixtral) alone, on one
NVIDIA GPU:

    python3 scripts/smoke_families.py [kernels]

Builds the CUDA kernels, then runs ``check_family_kernels`` (the attention
kernels at Falcon's GQA groups of 71, 29 and 16 and with ALiBi at BLOOM's
32 and 112 heads, K4 at group 71 and with ALiBi, K7 at Mixtral-8x7B's
widths) and, unless ``kernels`` is given, ``serve_families_and_check``
(each family's span served at its published widths and driven through the
port's client), with the same checks and prints as the full smoke. The
card's name and power limit are printed first. Exits non-zero on any
failure.
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
        print("smoke_families: no CUDA device available", file=sys.stderr)
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
    families, k7 = smoke.check_family_kernels(device, timer)
    smoke.log({"families": families, "grouped_matmul": k7})
    if sys.argv[1:] != ["kernels"]:
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as root:
            smoke.serve_families_and_check(root, device, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
