"""Plant faults in the decode dequant-matmul kernel and show that
chip_smoke.py's check rejects them, on one NVIDIA GPU.

    python3 scripts/plant_quant_faults.py

Builds faulty copies of petals_tpu_torch/csrc/quant_matmul.cu beside the
real one (into build/quant_faults/):

- "merge drops split 1": the last block to arrive at a slab cut between
  blocks adds every partial but the second block's;
- "a block skips one scale block": block 0 leaves the first unit of its run
  (one scale block of one 256-column slab) out of its sums;
- "scale of the previous block": every 4-bit scale block is decoded with the
  scales of the block before it (the first with its own).

and runs chip_smoke.py's check of the decode kernel (every arm the fault
can touch, at the four Mistral-7B projections and 1, 4, 8 and 32 rows:
against the plain version within QUANT_REL_TOL of the output's largest
magnitude, and bit-equal over repeats), each logging what it read beside its
limit. The real kernel runs every check first, as the control. Exits 0 when
the control passes every check and each fault is rejected by every check of
the arms it touches. The card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGE = ("              v[i][j] = b <= last && vj < total ? __ldcg(pb + (vj - second * n_vec))\n"
         "                                                : make_float4(0.f, 0.f, 0.f, 0.f);\n")
CONSUME = "      decode_unit<F, NT>(ring + s * S::STAGE_BYTES, lut, half, lane, acc);\n"
SCALES = ("        bulk_load(st + S::SCALE_OFFSET, static_cast<const __nv_bfloat16*>(scales) + static_cast<long>(kb) * N + "
          "col0,\n")
FOUR_BIT = ("nf4", "nf4a", "int4")
# fault: (the line it replaces, the planted text, the kinds whose check must reject it)
FAULTS = {
    "merge drops split 1": (MERGE, MERGE.replace("b <= last &&", "b <= last && b != first + 1 &&"),
                            FOUR_BIT + ("int8",)),
    "a block skips one scale block": (
        CONSUME, "      if (blockIdx.x != 0 || l != 0) " + CONSUME.lstrip(), FOUR_BIT + ("int8",)),
    "scale of the previous block": (
        SCALES, SCALES.replace("static_cast<long>(kb) * N", "static_cast<long>(kb > 0 ? kb - 1 : 0) * N"), FOUR_BIT),
}


def faulty_libraries(kbuild) -> dict:
    """{fault: library path}, compiled all at once."""
    out_dir = os.path.join(REPO, "build", "quant_faults")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(kbuild.CSRC_DIR, "quant_matmul.cu")).read()
    procs = {}
    for i, (fault, (line, planted, _)) in enumerate(FAULTS.items()):
        if src.count(line) != 1:
            raise SystemExit(f"quant_matmul.cu no longer has the line the fault {fault!r} replaces")
        cu, so = os.path.join(out_dir, f"f{i}.cu"), os.path.join(out_dir, f"libf{i}.so")
        with open(cu, "w") as f:
            f.write(src.replace(line, planted))
        procs[fault] = (so, subprocess.Popen(kbuild.nvcc_command(cu, so),
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for fault, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {fault!r}:\n{log}")
        libs[fault] = so
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("plant_quant_faults: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import quant_matmul as qmm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32, as chip_smoke.py runs it
    variants = {"control": kbuild.build("quant_matmul"), **faulty_libraries(kbuild)}
    real_load = kbuild.load
    device = torch.device("cuda", 0)

    def untimed(fn, *args, **kwargs):
        fn()
        return 1.0

    failures = []
    for variant, so in variants.items():
        qmm._LIB = None  # the wrapper binds whichever library kbuild.load returns
        kbuild.load = lambda name, so=so: ctypes.CDLL(so) if name == "quant_matmul" else real_load(name)
        kinds = chip_smoke.QUANT_KINDS if variant == "control" else FAULTS[variant][2]
        for kind in kinds:
            try:
                chip_smoke.check_quant_kernels(device, untimed, rows=chip_smoke.QUANT_DECODE_ROWS, kinds=(kind,))
                verdict = "passed"
            except AssertionError as e:
                verdict = f"rejected: {e}"
            print(f"{variant} | K{'6' if kind == 'int8' else '5'} decode {kind}: {verdict}", flush=True)
            if (variant == "control") != (verdict == "passed"):
                failures.append(f"{variant} | {kind}")
    kbuild.load = real_load
    qmm._LIB = None
    if failures:
        print("NOT as expected: " + "; ".join(failures), flush=True)
        return 1
    print("the control passed every check and every planted fault was rejected", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
