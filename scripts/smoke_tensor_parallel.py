"""chip_smoke.py's phase 26 (tensor parallelism on one card) alone, on one
NVIDIA GPU:

    python3 scripts/smoke_tensor_parallel.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint and a Llama-3-8B-config sibling over its
blocks, then runs ``serve_tensor_parallel_and_check``: K4, K5 nf4a and K6
at a tp=2 shard's shapes against their plain versions, then a tp=1 port
server and a ``num_tp_devices=2`` one whose two shards share the card, in
bf16, nf4a and int8, each with a private session, four pooled sessions, a
forward, a backward and (whole-model) a server-side generation, every
reply held to the float32 reference within twice the tp=1 server's
distance from it, with the same checks and prints as the full smoke. The
card's name and power limit are printed first. Exits non-zero on any
failure.

    python3 scripts/smoke_tensor_parallel.py --rehearse

runs the served part on the CPU at tiny widths (128 hidden, 4 / 2 heads of
32, 256 intermediate, a 512-token vocabulary), two CPU shards, with the
kernels' plain versions counted as their launches and dense caches
attending through K4's wrapper, as on the card: a rehearsal of the
phase's logic, which needs no card and measures nothing (about a minute).
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
    """Patch the phase onto the CPU at tiny widths: the card's
    synchronizations to no-ops, each kernel's plain version (what its
    wrapper runs on the CPU) counted as a launch of that kernel, and dense
    caches attending through K4's wrapper."""
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.server.backend import TransformerBackend

    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None
    tiny = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2, head_dim=32)
    smoke.MISTRAL_7B.update(tiny, vocab_size=512)
    smoke.LLAMA3_8B.update(tiny, vocab_size=512)
    smoke.TP_PROMPT = 40

    def flash_reference(*args, **kwargs):
        fa.flash_attend.launches += 1
        return plain_flash(*args, **kwargs)

    plain_flash = fa.flash_attend_reference
    fa.flash_attend_reference = flash_reference
    plain = qmm.dequant_matmul_reference

    def dequant_matmul_reference(x2d, w):
        fn = qmm.quant_decode_matmul if x2d.shape[0] <= 32 else qmm.quant_prefill_matmul
        fn.launches[w.kind] += 1
        return plain(x2d, w)

    qmm.dequant_matmul_reference = dequant_matmul_reference
    init = TransformerBackend.__init__

    def flash_init(self, *args, use_flash=None, **kwargs):
        init(self, *args, use_flash=True if use_flash is None else use_flash, **kwargs)

    TransformerBackend.__init__ = flash_init
    return torch.device("cpu")


def main() -> int:
    rehearse = "--rehearse" in sys.argv[1:]
    timer = None
    if rehearse:
        device, smi = _rehearse_on_cpu(), "CPU rehearsal, no card"
    else:
        if not torch.cuda.is_available():
            print("smoke_tensor_parallel: no CUDA device available", file=sys.stderr)
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
        timer = smoke.Timer(device)
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(REPO, "build", "throughput-cache"))
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke-ckpt-", dir=os.path.join(REPO, "build")) as ckpt:
        smoke.write_checkpoint(ckpt, device)
        result = smoke.serve_tensor_parallel_and_check(ckpt, device, smi, timer)
    smoke.log(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
