"""Where the bf16 chunked-prefill attention kernel's time goes, on one NVIDIA GPU.

    python3 scripts/ablate_paged_prefill.py

Builds ablated copies of petals_tpu_torch/csrc/paged_attention.cu beside the
real one (into build/ablate_prefill/) and times each against the real
paged_prefill_wgmma_kernel with chip_smoke.py's Timer, for each pool storage
(bf16, int8, nf4a) at chip_smoke.py's 512-row chunk at position 0 and its
long chunk at 3584 (a 4096-token table, three holes), Mistral-7B widths,
window 4096:

- "no score products": without the S = Q K^T wgmma (the scores stay 0);
- "no PV products": without the O += P V wgmma;
- "no softmax": without the online softmax (no max, exp2 or mask; P is the
  raw scores);
- "loads only": without the products and the softmax (the tile loads, the
  quantized decode, the barriers and the output are left);
- "no decode": a quantized tile is not decoded (the products read whatever
  the decoded tiles hold);
- "decode not overlapped": a quantized pool's scores and PV products are
  waited for as soon as they are issued, so tile j + 1's decode no longer
  runs under them.

The ablated kernels compute wrong outputs; only their times mean something
(the last variant is right, and is checked against the plain version). The card's name and power
limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORES = "        wgmma_m64n64k16_ss(acc, desc_k_major(q_tile + off), desc_k_major(ks + off), part + kk > 0);\n"
PV = "    for (int kk = 0; kk < 4; ++kk) wgmma_pv<DP>(o, a[kk], desc_mn_major(vs + kk * 2048));\n"
SOFTMAX = """    if (interior) {
      prefill_softmax<false>(scores, m_run, l_run, alpha, q_pos, t0, col0, kv_len, window, ok_col);
    } else {
      prefill_softmax<true>(scores, m_run, l_run, alpha, q_pos, t0, col0, kv_len, window, ok_col);
    }
"""
NO_SOFTMAX = "    alpha[0] = alpha[1] = 1.f;\n"
DECODE = "  for (int e = threadIdx.x; e < PF_KV * RCH; e += NT) {\n"  # decode_side's loop
QUANT_SCORES = "      issue_scores(s, base + dec_k(j));\n"
QUANT_PV = "      issue_pv(a, base + dec_k(j) + S::V_OFF);\n"


def ablated_sources(src: str) -> dict:
    if any(src.count(text) != 1 for text in (SCORES, PV, SOFTMAX, DECODE, QUANT_SCORES, QUANT_PV)):
        raise SystemExit("the prefill kernel no longer has the lines this script removes")
    no_products = src.replace(SCORES, "").replace(PV, "")
    wait = "      wgmma_wait0();\n"
    return {
        "kernel": src,
        "no score products": src.replace(SCORES, ""),
        "no PV products": src.replace(PV, ""),
        "no softmax": src.replace(SOFTMAX, NO_SOFTMAX),
        "loads only": no_products.replace(SOFTMAX, NO_SOFTMAX),
        "no decode": src.replace(DECODE, DECODE.replace("e < PF_KV * RCH", "e < 0")),
        "decode not overlapped": src.replace(QUANT_SCORES, QUANT_SCORES + wait).replace(QUANT_PV, QUANT_PV + wait),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_paged_prefill: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import paged_flash_attention as pfa
    from petals_tpu_torch.ops.paged_attention import PagedPool, paged_prefill_attend, quantize_kv_rows

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(REPO, "build", "ablate_prefill")
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
    window = chip_smoke.MISTRAL_7B["sliding_window"]
    _, pf = chip_smoke.attention_cases(device)
    short = (pf["chunks"][0], pf["kp"], pf["vp"], pf["table_row"], 0)
    long = chip_smoke.long_prefill_case(device, 3584, 4096)
    long = (long[0], long[1], long[2], long[3], 3584)
    cases = {}
    for kind in ("none", "int8", "nf4a"):
        for shape, (q, kp, vp, row, pos) in (("512 rows at 0", short), ("512 rows at 3584", long)):
            if kind != "none":
                kp, vp = (PagedPool(*quantize_kv_rows(p, kind)) for p in (kp, vp))
            # the chunk's position and length on the card, as the served step passes them
            cases[f"{kind}, {shape}"] = (q, kp, vp, row, pos, q.shape[1], pfa.chunk_scalars(pos, q.shape[1], device))
    for name, so in libs.items():
        pfa._LIB = None  # the wrapper binds whichever library kbuild.load returns
        kbuild.load = lambda _name, so=so: ctypes.CDLL(so)
        times = {}
        for case, (q, kp, vp, row, pos, n, scalars) in cases.items():
            if name in ("no decode", "decode not overlapped") and case.startswith("none"):
                continue
            if name == "decode not overlapped":  # a right kernel: hold it to its limit
                want = paged_prefill_attend(q.float(), *((kp.float(), vp.float()) if case.startswith("none")
                                                         else (kp, vp)), row, pos, n, sliding_window=window)
                got = pfa.paged_flash_prefill_attend(q, kp, vp, row, *scalars, sliding_window=window)
                chip_smoke.check_rows(f"{name}, {case}", got, want, chip_smoke.ROW_REL_TOL if case.startswith("none")
                                      else chip_smoke.KV_ROW_REL_TOL)
            times[case] = timer(lambda c=(q, kp, vp, row, *scalars): pfa.paged_flash_prefill_attend(
                *c, sliding_window=window))
        print(f"{name}: " + ", ".join(f"{case} {t:.4f} ms" for case, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
