"""Where the decode dequant-matmul kernel's time goes, on one NVIDIA GPU.

    python3 scripts/ablate_quant_decode.py

Builds ablated copies of petals_tpu_torch/csrc/quant_matmul.cu beside the
real one (into build/ablate_decode/): without the weight decode (the raw
words go to the products as they are), without the mma products (the
decoded weights are folded into the sums by an xor, so the decode stays
live), with the consumers doing nothing but wait for each stage and release
it (the producer's TMA copies, the mbarriers and the merge are left),
without the merge of cut slabs (their partials are written, never added),
and with no unit dealt to any block (launch, table and barriers only); and
times each against the real kernel at Mistral-7B's four projections (wqkv,
wo, gate+up, down) at 8 and 32 rows, for nf4a and int8, with CUDA events and the L2
cache flushed before every launch (chip_smoke.py's Timer).
Then the real kernel at each ring depth the plan could choose (two rings of
2 to 4 stages). The ablated kernels compute wrong outputs; only their times mean
something. The card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOKUP = "uint32_t lane4, uint32_t scale2) {\n"
INT8_PAIR = "int8_pair(uint32_t lo, uint32_t hi) {\n"
PRODUCTS = "      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt][t], a, bx[nt][0], bx[nt][1]);\n"
CONSUME = "      decode_unit<F, NT>(ring + s * S::STAGE_BYTES, lut, half, lane, acc);\n"
MERGE = "    if (halves != 0) {\n"
DEAL = "  const long u_begin = unit_begin(units, blockIdx.x, G), u_end = unit_begin(units, blockIdx.x + 1, G);\n"
DATA_MAP = ("  if (!encode_2d(&data_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, data, N, static_cast<long>(K / QBLOCK) * "
            "S::RAW_ROWS,\n")
BOXES = ("      tma_load_2d(st, &data_map, col0, kb * S::RAW_ROWS, bar);\n"
         "      tma_load_2d(st + S::HALF_BYTES, &data_map, col0 + 128, kb * S::RAW_ROWS, bar);\n")
SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672), "wd": (14336, 4096)}
ROWS = (8, 32)  # a served decode batch, and the decode kernel's most rows


def ablated_sources(src: str) -> dict:
    for line in (LOOKUP, INT8_PAIR, PRODUCTS, CONSUME, MERGE, DEAL, DATA_MAP, BOXES):
        if src.count(line) != 1:
            raise SystemExit(f"the decode kernel no longer has the line this script edits: {line!r}")
    loads_only = src.replace(CONSUME, "      acc[0][0][0] += 1.f;\n")
    # the same bytes a unit, read as two contiguous 4 KB (int8 8 KB) runs: the weight viewed as [rows, 128]
    contiguous = loads_only.replace(DATA_MAP, DATA_MAP.replace(
        "data, N, static_cast<long>(K / QBLOCK) * S::RAW_ROWS,",
        "data, 128, static_cast<long>(K / QBLOCK) * S::RAW_ROWS * (N / 128),")
    ).replace(BOXES, "      tma_load_2d(st, &data_map, 0, static_cast<int>(2 * (u_begin + l)) * S::RAW_ROWS, bar);\n"
                     "      tma_load_2d(st + S::HALF_BYTES, &data_map, 0,\n"
                     "                  static_cast<int>(2 * (u_begin + l) + 1) * S::RAW_ROWS, bar);\n")
    no_decode = src.replace(LOOKUP, LOOKUP + "  return w ^ scale2;\n")
    no_decode = no_decode.replace(INT8_PAIR, INT8_PAIR + "  return lo ^ hi;\n")
    sink = ("      for (int nt = 0; nt < NT; ++nt)\n"
            "        acc[nt][t][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ bx[nt][0]) & 0x3FFFFFu);\n")
    return {
        "kernel": src,
        "no decode": no_decode,
        "no products": src.replace(PRODUCTS, sink),
        "loads only": loads_only,
        "loads only, contiguous": contiguous,
        "no merge": src.replace(MERGE, "    if (false) {\n"),
        "launch only": src.replace(DEAL, DEAL.replace("u_begin = unit_begin(units, blockIdx.x, G)", "u_begin = 0")
                                   .replace("u_end = unit_begin(units, blockIdx.x + 1, G)", "u_end = 0")),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_quant_decode: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import quant_matmul as qmm
    from petals_tpu_torch.ops.quant import quantize

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(REPO, "build", "ablate_decode")
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
    cases = {}
    for shape, (k, n) in SHAPES.items():
        dense = (torch.randn(k, n, generator=gen, device=device) * 0.02).to(torch.bfloat16)
        weights = {kind: quantize(dense, kind) for kind in ("nf4a", "int8")}
        for m in ROWS:
            x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
            print(f"{shape} [{m}, {k}] @ [{k}, {n}]: dense bf16 torch.matmul "
                  f"{timer(lambda: torch.matmul(x, dense)):.4f} ms; bound " + ", ".join(
                      f"{kind} {chip_smoke.bound_ms(*chip_smoke.quant_bytes_and_flops(m, w))[0]:.4f} ms"
                      for kind, w in weights.items()), flush=True)
            cases[f"{shape} M={m}"] = (x, weights)
        del dense
    for name, so in libs.items():
        qmm._LIB = None  # the wrapper binds whichever library kbuild.load returns
        kbuild.load = lambda _name, so=so: ctypes.CDLL(so)
        for shape, (x, weights) in cases.items():
            times = {kind: timer(lambda w=w: qmm.quant_decode_matmul(x, w)) for kind, w in weights.items()}
            print(f"{name}, {shape}: " + ", ".join(f"{kind} {t:.4f} ms" for kind, t in times.items()), flush=True)
    for name in ("kernel", "loads only"):  # on half the SMs: is a block's stream, or the memory, the limit?
        qmm._LIB = None
        kbuild.load = lambda _name, so=libs[name]: ctypes.CDLL(so)
        sm_count, qmm._sm_count = qmm._sm_count, lambda device: 66
        for shape, (x, weights) in cases.items():
            times = {kind: timer(lambda w=w: qmm.quant_decode_matmul(x, w)) for kind, w in weights.items()}
            print(f"{name}, 66 blocks, {shape}: " + ", ".join(f"{kind} {t:.4f} ms" for kind, t in times.items()),
                  flush=True)
        qmm._sm_count = sm_count
    qmm._LIB = None
    kbuild.load = lambda _name: ctypes.CDLL(libs["kernel"])
    ring_bytes = qmm._DEC_RING_BYTES
    for stages in (3, 2, 4, 4, 2, 3):  # the plan's ring depth, forced through its byte target; in turns
        line = []
        for shape, (x, weights) in cases.items():
            if shape not in ("wgu M=8", "wd M=8"):
                continue
            for kind, w in weights.items():
                stage_bytes = (64 if kind == "int8" else 32) * qmm._DEC_SLAB
                qmm._DEC_RING_BYTES = 2 * stages * stage_bytes
                assert qmm.decode_plan(x.shape[0], w.in_features, w.out_features, 132, kind).stages == stages
                line.append(f"{shape} {kind} {timer(lambda w=w: qmm.quant_decode_matmul(x, w)):.4f} ms")
        print(f"kernel, {stages} stages: " + ", ".join(line), flush=True)
    qmm._DEC_RING_BYTES = ring_bytes
    return 0


if __name__ == "__main__":
    sys.exit(main())
