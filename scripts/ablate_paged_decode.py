"""Where the paged decode attention kernel's time goes, on one NVIDIA GPU.

    python3 scripts/ablate_paged_decode.py

Builds ablated copies of petals_tpu_torch/csrc/paged_attention.cu beside the
real one (into build/ablate_decode/): without the score products, without
the PV products, without either (the page loads, the online softmax's
bookkeeping and the barriers are left), and without the split merge (every
block returns after writing its partial), and times each against the real
kernel (bf16 pools at Mistral-7B widths, window 4096) at chip_smoke.py's
phase-2 shape (8 lanes up to 1023 tokens) and its two long contexts (one
lane and 8 lanes at position 4095), with chip_smoke.py's Timer. The ablated
kernels compute wrong outputs; only their times mean something. The card's
name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = "      for (int c = sub; c < NCH; c += TPR) {"
PV = "      for (int r = set; set < S::NSET && r < TR; r += S::NSET) {"
MERGE = "  if (!last) return;"


def ablated_sources(src: str) -> dict:
    if any(src.count(line) != 1 for line in (SCORES, PV, MERGE)):
        raise SystemExit("the decode kernel no longer has the lines this script removes")
    no_scores = src.replace(SCORES, "      for (int c = NCH; c < NCH; c += TPR) {")
    return {
        "kernel": src,
        "no scores": no_scores,
        "no PV": src.replace(PV, "      for (int r = TR; r < TR; r += S::NSET) {"),
        "loads only": no_scores.replace(PV, "      for (int r = TR; r < TR; r += S::NSET) {"),
        "no merge": src.replace(MERGE, "  return;"),
    }


def decode_case(device, seed, n_lanes, max_pages, positions):
    """bf16 pools at Mistral-7B widths (32 query heads over 8, head_dim 128,
    page 64) on permuted tables of ``max_pages`` pages a lane."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_pages = n_lanes * max_pages
    tables = torch.randperm(n_pages, generator=torch.Generator().manual_seed(seed)).to(torch.int32)
    kp, vp = (torch.randn(n_pages, 64, 8, 128, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    q = torch.randn(n_lanes, 1, 32, 128, generator=gen, device=device).to(torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=device)
    return q, kp, vp, tables.reshape(n_lanes, max_pages).to(device), pos


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_paged_decode: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import paged_flash_attention as pfa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(REPO, "build", "ablate_decode")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(kbuild.CSRC_DIR, "paged_attention.cu")).read()
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
    cases = {
        "8 lanes up to 1023": decode_case(device, 1, 8, 16, [0, 63, 64, 200, 511, 700, 1023, 1024]),
        "1 lane at 4095": decode_case(device, 2, 1, 64, [4095]),
        "8 lanes at 4095": decode_case(device, 3, 8, 64, [4095] * 8),
    }
    for name, so in libs.items():
        pfa._LIB = None  # the wrapper binds whichever library kbuild.load returns
        kbuild.load = lambda _name, so=so: ctypes.CDLL(so)
        times = {case: timer(lambda c=c: pfa.paged_flash_attend(*c, sliding_window=4096)) for case, c in cases.items()}
        print(f"{name}: " + ", ".join(f"{case} {t:.4f} ms" for case, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
