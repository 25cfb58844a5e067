"""chip_smoke.py's phase 29 (the step-program observatory's records and
costs) alone, on one NVIDIA GPU:

    python3 scripts/smoke_observatory.py [telemetry]

Builds the CUDA kernels, then (c) holds each kernel wrapper's reported cost
to the smoke's own count at its timed cases (K1-K3 at Mistral-7B's widths,
K4's four cases, K5/K6 at the four projections at 1 to 512 rows, K7 at
Mixtral-8x7B's), writes chip_smoke.py's seeded 8-block Mistral-7B-width
checkpoint, serves it in bf16 (phase 3) and runs (d) ``check_counting``
(replays bit-equal with costs counted at capture and without, the counting's
share of the capture seconds, one anomaly on a real graph) and (a), (b)
``profile_steps(check_costs=True)`` (the decode step's flops against the
analytic count, bytes against the weights, the roofline of the replayed
decode and mixed steps); then the same profile on nf4a weights. With
``telemetry``, phase 21 too, whose ``/compile`` check is (e). The card's
name and power limit are printed first. Exits non-zero on any failure.
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
        print("smoke_observatory: no CUDA device available", file=sys.stderr)
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
    dec, pf = smoke.attention_cases(device)
    smoke.check_attention_kernels(device, timer, dec, pf, long=False)
    for kind in smoke.KV_QUANT_KINDS:
        smoke.check_attention_kernels(device, timer, dec, pf, kind, long=False)
    smoke.check_flash_kernel(device, timer)
    smoke.check_quant_kernels(device, timer, time_all=False)
    smoke.check_grouped_matmul(device, timer)
    smoke.log(f"phase 29 (c): wrapper costs equal to the smoke's counts: {dict(smoke.COST_CHECKS)}")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    result = {}
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        for quant_type in ("none", "nf4a"):
            server, _ = smoke.serve_and_check(ckpt, device, quant_type, smoke.SPAN, smoke.PROMPTS[-1:], 4,
                                              smoke.SEED + 4, None)
            if quant_type == "none":
                result["counting"] = smoke.check_counting(
                    server.backend, device, f"phase 29 (--quant_type none, {smoke.SPAN} blocks)")
            result[quant_type] = smoke.profile_steps(server.backend, device, smi=smi, check_costs=True)["costs"]
            del server
            smoke.free_card()
        if "telemetry" in sys.argv[1:]:
            smoke.serve_forward_telemetry_and_check(ckpt, device, smi)
    smoke.log(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
