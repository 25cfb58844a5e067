"""chip_smoke.py's phase 25 (swarm operations) alone, on one NVIDIA GPU:

    python3 scripts/smoke_swarm_ops.py

Builds the CUDA kernels, writes chip_smoke.py's seeded 8-block
Mistral-7B-width checkpoint, then runs ``serve_swarm_ops_and_check``: an
nf4a server's cold and warm starts over one quantized-block cache, the
balance loop moving one of two servers and a resize under a live client
session, the chaos plane's faults, a seeded traffic schedule against a
batched and a ``--no_batching`` server, and the autoscaler resizing a
server, with the same checks and prints as the full smoke. The card's name
and power limit are printed first. Exits non-zero on any failure.

    python3 scripts/smoke_swarm_ops.py --rehearse

runs the same phase on the CPU at tiny widths (64 hidden, 4 / 2 heads of
16, 128 intermediate and vocabulary), with the kernels' plain versions
counted as their launches and dense caches attending through K4's
wrapper, as on the card: a rehearsal of the phase's logic, which needs
no card and measures nothing (about a minute).
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
    """Patch the phase onto the CPU at tiny widths: every entry point's
    device to the CPU, the card's synchronizations to no-ops, and each
    kernel's plain version (what its wrapper runs on the CPU) counted as a
    launch of that kernel."""
    from petals_tpu_torch.client import from_pretrained as client_fp
    from petals_tpu_torch.client import model as client_model
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.server import from_pretrained as server_fp
    from petals_tpu_torch.server import server as server_mod
    from petals_tpu_torch.server.backend import TransformerBackend

    cpu = torch.device("cpu")
    for mod in (server_mod, server_fp, client_model, client_fp):
        mod.resolve_device = lambda device=None: cpu
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None
    smoke.MISTRAL_7B.update(hidden_size=64, intermediate_size=128, num_attention_heads=4, num_key_value_heads=2,
                            head_dim=16, vocab_size=128)

    def counted(fn, owner, attr, key_of=None):
        def wrapper(*args, **kwargs):
            if key_of is None:
                setattr(owner, attr, getattr(owner, attr) + 1)
            else:
                getattr(owner, attr)[key_of(*args)] += 1
            return fn(*args, **kwargs)

        return wrapper

    pfa.paged_attend = counted(pfa.paged_attend, pfa.paged_flash_attend, "launches")
    pfa.paged_prefill_attend = counted(pfa.paged_prefill_attend, pfa.paged_flash_prefill_attend, "launches")
    fa.flash_attend_reference = counted(fa.flash_attend_reference, fa.flash_attend, "launches")
    plain = qmm.dequant_matmul_reference

    def dequant_matmul_reference(x2d, w):
        fn = qmm.quant_decode_matmul if x2d.shape[0] <= 32 else qmm.quant_prefill_matmul
        fn.launches[w.kind] += 1
        return plain(x2d, w)

    qmm.dequant_matmul_reference = dequant_matmul_reference
    # dense caches attend through K4's wrapper, as on the card
    init = TransformerBackend.__init__

    def flash_init(self, *args, use_flash=None, **kwargs):
        init(self, *args, use_flash=True if use_flash is None else use_flash, **kwargs)

    TransformerBackend.__init__ = flash_init
    return cpu


def main() -> int:
    rehearse = "--rehearse" in sys.argv[1:]
    if rehearse:
        device, smi = _rehearse_on_cpu(), "CPU rehearsal, no card"
    else:
        if not torch.cuda.is_available():
            print("smoke_swarm_ops: no CUDA device available", file=sys.stderr)
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
        result = smoke.serve_swarm_ops_and_check(ckpt, device, smi)
    smoke.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
