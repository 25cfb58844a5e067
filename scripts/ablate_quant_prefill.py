"""Where the prefill dequant-matmul kernel's time goes, on one NVIDIA GPU.

    python3 scripts/ablate_quant_prefill.py

Builds three ablated copies of petals_tpu_torch/csrc/quant_matmul.cu beside
the real one (into build/ablate/): without the weight decode, without the
wgmma products, and without either (only the loads, the barriers and the
stores are left), and times each against the real kernel at Mistral-7B's
fused gate+up [4096, 28672] at 512 rows, for nf4a and int8, with CUDA events
and the L2 cache flushed before every launch (chip_smoke.py's Timer). The
ablated kernels compute wrong outputs; only their times mean something. The
card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE = "    if (s + 1 < n_steps) decode_step(s + 1);"
PRODUCTS = (
    "        wgmma_m64n128k16(acc[t], hopper::desc_k_major(xa + t * 64 * PF_ROW_BYTES + 32 * k),\n"
    "                         hopper::desc_k_major(bb + 32 * k));"
)


def ablated_sources(src: str) -> dict:
    if src.count(DECODE) != 1 or src.count(PRODUCTS) != 1:
        raise SystemExit("the kernel's main loop no longer has the lines this script removes")
    no_products = src.replace(PRODUCTS, "        continue;")
    return {
        "kernel": src,
        "no decode": src.replace(DECODE, ""),
        "no products": no_products,
        "loads only": no_products.replace(DECODE, ""),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_quant_prefill: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.ops.quant import quantize

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(REPO, "build", "ablate")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(kbuild.CSRC_DIR, "quant_matmul.cu")).read()
    procs = {}
    for i, (name, text) in enumerate(ablated_sources(src).items()):
        cu, so = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(kbuild.nvcc_command(cu, so),
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = so

    device = torch.device("cuda", 0)
    timer = chip_smoke.Timer(device)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 7)
    k, n, m = 4096, 28672, 512
    dense = (torch.randn(k, n, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    weights = {kind: quantize(dense, kind) for kind in ("nf4a", "int8")}
    print(f"dense bf16 torch.matmul at [{m}, {k}] @ [{k}, {n}]: {timer(lambda: torch.matmul(x, dense)):.4f} ms")
    for name, so in libs.items():
        qmm._LIB = None  # the wrapper binds whichever library kbuild.load returns
        kbuild.load = lambda _name, so=so: ctypes.CDLL(so)
        times = {kind: timer(lambda w=w: qmm.quant_prefill_matmul(x, w)) for kind, w in weights.items()}
        print(f"{name}: " + ", ".join(f"{kind} {t:.4f} ms" for kind, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
