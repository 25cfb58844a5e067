"""chip_smoke.py's phase 27 (sequence parallelism on one card) alone, on one
NVIDIA GPU:

    python3 scripts/smoke_sequence_parallel.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint and the Llama-3-8B-config sibling over its
blocks, then runs ``serve_sequence_parallel_and_check``: K4 at the query
shards' shapes and K5 nf4a / K6 prefill at a rank's rows of a tp=2
shard's projections against their plain versions; an unsharded port
server beside a ``num_sp_devices=2`` one (4 blocks, bf16), then beside a
tp=2 x sp=2 one (2 blocks; bf16, nf4a, int8), then beside a tp=2 one with
a LoRA adapter, every shard and rank on the card; every reply, private
K/V row, forward and gradient held to the float32 reference within twice
the unsharded server's distance from it; the Gemma-2 and sp-only nf4a
refusals; with the same checks and prints as the full smoke. The card's
name and power limit are printed first. Exits non-zero on any failure.

    python3 scripts/smoke_sequence_parallel.py --rehearse

runs the served part on the CPU at tiny widths (128 hidden, 4 / 2 heads of
32, 256 intermediate, a 512-token vocabulary, prompts cut to tens of
tokens), every shard and rank a CPU one, with the kernels' plain versions
counted as their launches and dense caches attending through K4's
wrapper, as on the card: a rehearsal of the phase's logic, which needs no
card and measures nothing.
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
    smoke.SP_PRIVATE, smoke.SP_MAX_LENGTH, smoke.SP_LANE_PROMPT, smoke.SP_LANE_LENGTH = 40, 128, 24, 64
    smoke.SP_FORWARD, smoke.SP_BACKWARD, smoke.SP_GRID_PROMPT = 64, 32, 80  # a rank of 80 rows: > 32, prefill

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
            print("smoke_sequence_parallel: no CUDA device available", file=sys.stderr)
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
        result = smoke.serve_sequence_parallel_and_check(ckpt, device, smi, timer)
    smoke.log(json.dumps(result, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
