"""Plant faults in the attention kernels and show that chip_smoke.py's checks
reject them, on one NVIDIA GPU.

    python3 scripts/plant_attention_faults.py

Builds faulty copies of petals_tpu_torch/csrc's attention sources beside the
real ones (into build/faults/):

- "merge drops split 1": the paged decode kernel's merge gives split 1 of
  every (lane, kv head) the weight 0, so that run's keys leave the softmax
  and the rest is renormalised (the subtle way to lose a split);
- "float32 read as bf16": the float32 flash kernel rounds every q, k and v
  element it reads to bf16;
- "prefill skips an interior tile": the bf16 prefill kernel leaves the
  second tile of each block out of the softmax and the PV product where it is
  an interior tile (below the diagonal, no hole);
- "prefill leaves holes unmasked": the bf16 prefill kernel's edge mask
  ignores the valid flags, so a hole's zero-filled rows score 0 and take a
  share of the softmax.

and runs chip_smoke.py's checks of the kernel each fault is planted in (K1
at phase 2's shape and at its long contexts, K3 decode's int8 and nf4a arms;
K4 at its four cases, bf16 and float32; K2 at its long chunks, row by row),
each logging what it read beside its limit. The real kernels run every
check first, as the control. Exits 0 when the control passes every check and
each fault is rejected by every check of its kernel. The card's name and
power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGE_WEIGHT = "      const float w = ml.y > 0.f ? expf(ml.x - mx) : 0.f;"
F32_READ = "__device__ __forceinline__ float to_f32(float x) { return x; }"
INTERIOR = """    if (interior) {
      prefill_softmax<false>("""
HOLE_MASK = "        const bool ok = ok_col[col] && kv <= q_pos[j]"
# fault: (source, the line it replaces, the planted text, the checks it must fail)
FAULTS = {
    "merge drops split 1": ("paged_attention", MERGE_WEIGHT,
                            "      const float w = ml.y > 0.f && s != 1 ? expf(ml.x - mx) : 0.f;", ("K1", "K3 decode")),
    "float32 read as bf16": ("flash_attention", F32_READ,
                             "__device__ __forceinline__ float to_f32(float x) "
                             "{ return __bfloat162float(__float2bfloat16(x)); }", ("K4",)),
    "prefill skips an interior tile": ("paged_attention", INTERIOR, """    if (interior && j == 1) {
      alpha[0] = alpha[1] = 1.f;
      for (int i = 0; i < 32; ++i) scores[i] = 0.f;
    } else if (interior) {
      prefill_softmax<false>(""", ("K2",)),
    "prefill leaves holes unmasked": ("paged_attention", HOLE_MASK, "        const bool ok = kv <= q_pos[j]", ("K2",)),
}


def faulty_libraries(kbuild) -> dict:
    """{fault: {source name: library path}}, compiled all at once."""
    out_dir = os.path.join(REPO, "build", "faults")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (fault, (name, line, planted, _)) in enumerate(FAULTS.items()):
        src = open(os.path.join(kbuild.CSRC_DIR, f"{name}.cu")).read()
        if src.count(line) != 1:
            raise SystemExit(f"{name}.cu no longer has the line the fault {fault!r} replaces")
        cu, so = os.path.join(out_dir, f"f{i}.cu"), os.path.join(out_dir, f"libf{i}.so")
        with open(cu, "w") as f:
            f.write(src.replace(line, planted))
        procs[fault] = (name, so, subprocess.Popen(kbuild.nvcc_command(cu, so),
                                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for fault, (name, so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {fault!r}:\n{log}")
        libs[fault] = {name: so}
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("plant_attention_faults: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops import paged_flash_attention as pfa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full float32, as chip_smoke.py runs them
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.build()
    variants = {"control": {}, **faulty_libraries(kbuild)}
    real_load = kbuild.load
    device = torch.device("cuda", 0)
    dec, pf = chip_smoke.attention_cases(device)

    def untimed(fn, *args, **kwargs):
        fn()
        return 1.0

    # check: (the kernel it holds, the call)
    checks = {
        "K1, phase 2": ("K1", lambda: chip_smoke.check_attention_kernels(device, untimed, dec, pf)),
        **{f"K1, {n} lane(s) x {p}, tables of {t}": (
            "K1", lambda case=(n, p, t): chip_smoke.check_long_decode(device, untimed, *case))
           for n, p, t in chip_smoke.LONG_DECODE},
        **{f"K3 {kind} decode": (
            "K3 decode", lambda kind=kind: chip_smoke.check_attention_kernels(device, untimed, dec, pf, kind))
           for kind in chip_smoke.KV_QUANT_KINDS},
        "K4, cases a-d": ("K4", lambda: chip_smoke.check_flash_kernel(device, untimed)),
        **{f"K2, 512 rows x position {p}, tables of {t}": (
            "K2", lambda case=(p, t): chip_smoke.check_long_prefill(device, untimed, "none", *case))
           for p, t in chip_smoke.LONG_PREFILL},
    }
    failures = []
    for variant, libs in variants.items():
        pfa._LIB = fa._LIB = None  # the wrappers bind whichever library kbuild.load returns
        kbuild.load = lambda name, libs=libs: ctypes.CDLL(libs[name]) if name in libs else real_load(name)
        for check, (kernel, run) in checks.items():
            if variant != "control" and kernel not in FAULTS[variant][3]:
                continue
            try:
                run()
                verdict = "passed"
            except AssertionError as e:
                verdict = f"rejected: {e}"
            print(f"{variant} | {check}: {verdict}", flush=True)
            if (variant == "control") != (verdict == "passed"):
                failures.append(f"{variant} | {check}")
    kbuild.load = real_load
    if failures:
        print("NOT as expected: " + "; ".join(failures), flush=True)
        return 1
    print("the control passed every check and every planted fault was rejected", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
