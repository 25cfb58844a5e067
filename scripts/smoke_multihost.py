"""chip_smoke.py's phase 28 (multi-host lockstep serving on one card) alone,
on one NVIDIA GPU:

    python3 scripts/smoke_multihost.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint and the Llama-3-8B-config sibling over its
blocks, then runs ``serve_multihost_and_check``: for tp=2 in bf16, nf4a
and int8 and for sp=2 in bf16, an unsharded port server beside a
two-process group (this process's ``Server(num_hosts=2)`` and one
``python -m petals_tpu_torch.cli.run_worker``, both on the card, the data
group on gloo), the same seeded traffic for both; every reply, K/V row
and gradient held to the float32 reference within twice the unsharded
server's distance from it; K4, K5 and K6 counted on both processes; the
host walls of an op beside one-process ones; then the worker killed, the
leader degraded and re-formed single-host. The card's name and power limit
are printed first. Exits non-zero on any failure.

    python3 scripts/smoke_multihost.py --rehearse

runs it on the CPU at tiny widths (128 hidden, 4 / 2 heads of 32, 256
intermediate, a 512-token vocabulary, prompts cut to tens of tokens),
leader and worker both on the CPU, with the kernels' plain versions
counted as their launches on both processes and dense caches attending
through K4's wrapper, as on the card: a rehearsal of the phase's logic,
which needs no card and measures nothing.
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


def _rehearse_on_cpu() -> torch.device:
    """The phase on the CPU at tiny widths, in this process or the worker:
    the card's synchronizations to no-ops, each kernel's plain version
    counted as a launch of that kernel, dense caches attending through
    K4's wrapper."""
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.server.backend import TransformerBackend

    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None
    tiny = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2, head_dim=32)
    smoke.MISTRAL_7B.update(tiny, vocab_size=512)
    smoke.LLAMA3_8B.update(tiny, vocab_size=512)
    smoke.SP_MAX_LENGTH, smoke.SP_LANE_LENGTH = 128, 64
    smoke.MH_PROMPT, smoke.MH_SP_FORWARD, smoke.MH_TIMING_REPS = 40, 64, 1
    plain_flash, plain_mm = fa.flash_attend_reference, qmm.dequant_matmul_reference

    def flash_reference(*args, **kwargs):
        fa.flash_attend.launches += 1
        return plain_flash(*args, **kwargs)

    def dequant_matmul_reference(x2d, w):
        fn = qmm.quant_decode_matmul if x2d.shape[0] <= 32 else qmm.quant_prefill_matmul
        fn.launches[w.kind] += 1
        return plain_mm(x2d, w)

    fa.flash_attend_reference = flash_reference
    qmm.dequant_matmul_reference = dequant_matmul_reference
    init = TransformerBackend.__init__

    def flash_init(self, *args, use_flash=None, **kwargs):
        init(self, *args, use_flash=True if use_flash is None else use_flash, **kwargs)

    TransformerBackend.__init__ = flash_init
    smoke.MH_WORKER_CMD = [sys.executable, os.path.abspath(__file__), "--rehearse-worker"]
    return torch.device("cpu")


def main() -> int:
    if sys.argv[1:2] == ["--rehearse-worker"]:  # the rehearsal's run_worker, patched as the leader is
        _rehearse_on_cpu()
        from petals_tpu_torch.cli import run_worker

        run_worker.main(sys.argv[2:])
        return 0
    if "--rehearse" in sys.argv[1:]:
        device = _rehearse_on_cpu()
        os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
            smoke.write_checkpoint(ckpt, device)
            result = smoke.serve_multihost_and_check(ckpt, device, "CPU rehearsal, no card")
        smoke.log(json.dumps(result, default=str))
        return 0
    if not torch.cuda.is_available():
        print("smoke_multihost: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    smoke.log(smi)
    smoke.build()
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(REPO, "build", "throughput-cache"))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        result = smoke.serve_multihost_and_check(ckpt, device, smi)
    smoke.log(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
