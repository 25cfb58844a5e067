"""Where the time of K7's bf16 arm (the grouped expert product on wgmma with
a TMA ring) goes, on one NVIDIA GPU.

    python3 scripts/ablate_grouped_matmul.py

Builds edited copies of petals_tpu_torch/csrc/grouped_matmul.cu beside the
real one (into build/ablate-grouped/): at other ring configurations (tile
columns TN and stages STAGES, set by rewriting the source's two constexpr
lines; a 128-column copy gets its own m64n128k16 product, written out by
this script), without the wgmma products (the copies, the barriers and the
stores are left), without the copies (the producer arrives on each stage
with no bytes, so the products read whatever shared memory holds) and
without the stores. Times each copy and the real kernel (256 x 4), at
chip_smoke.py's Mixtral-8x7B case (1024
assignment rows in GROUPED_SIZES over w1 [8, 4096, 14336] and w2 [8, 14336,
4096]), beside torch._grouped_mm where the card's torch has it, with CUDA
events and the L2 cache flushed before every launch (chip_smoke.py's Timer).
The ablated kernels compute wrong outputs; only their times mean something.
The card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = ("constexpr int TN = 256;\n", "constexpr int STAGES = 4;\n")
PRODUCT_CALL = "      hopper::wgmma_m64n256k16_ss_tb(acc, "
PRODUCTS = (PRODUCT_CALL + "hopper::desc_k_major(st + a_off + 32 * kk),\n"
            "                                     hopper::desc_mn_major(st + A_BYTES + 2048 * kk), 1);\n")
COPIES = ("        mbar_expect_tx(bar, STAGE_BYTES);\n"
          "        hopper::tma_load_2d(st, &x_map, i * RING_BK, t.start, bar);\n"
          "#pragma unroll\n"
          "        for (int j = 0; j < TN / 64; ++j)\n"
          "          hopper::tma_load_3d(st + A_BYTES + j * ATOM_BYTES, &w_map, col0 + 64 * j, i * RING_BK, "
          "t.expert, bar);\n")
STORES = ("        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =\n"
          "            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);\n")


# the ring configurations timed beside the source's own (256 x 4)
OTHER_RINGS = ((256, 3), (128, 6), (128, 4))


def product_source(tn: int) -> str:
    """wgmma m64n{tn}k16 from shared memory, A K-major, B MN-major (the
    transpose-B bit set), as hopper_wgmma.cuh writes the 256-column one."""
    regs = tn // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    binds = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return (f"__device__ __forceinline__ void wgmma_m64n{tn}k16_ss_tb(float (&d)[{regs}], uint64_t da, "
            f"uint64_t db, int accumulate) {{\n"
            f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
            f'               "wgmma.mma_async.sync.aligned.m64n{tn}k16.f32.bf16.bf16 {{{outs}}}, '
            f'%{regs}, %{regs + 1}, p, 1, 1, 0, 1;\\n}}\\n"\n'
            f'               : {binds} : "l"(da), "l"(db), "r"(accumulate));\n}}\n')


def with_ring(src: str, tn: int, stages: int) -> str:
    out = src.replace(RING[0], f"constexpr int TN = {tn};\n").replace(RING[1], f"constexpr int STAGES = {stages};\n")
    if tn != 256:
        include = '#include "hopper_wgmma.cuh"\n'
        out = out.replace(include, include + "\n" + product_source(tn))
        out = out.replace(PRODUCT_CALL, f"      wgmma_m64n{tn}k16_ss_tb(acc, ")
    return out


def ablated_sources(src: str) -> dict:
    for line in RING + (PRODUCT_CALL, PRODUCTS, COPIES, STORES):
        if src.count(line) != 1:
            raise SystemExit(f"the bf16 arm no longer has the lines this script edits: {line!r}")
    return {
        "kernel": src,
        **{f"ring {tn}x{stages}": with_ring(src, tn, stages) for tn, stages in OTHER_RINGS},
        "no products": src.replace(PRODUCTS, "      acc[kk] += 1.f;\n"),
        "no copies": src.replace(COPIES, "        (void)st;\n        mbar_arrive(bar);\n"),
        "no stores": src.replace(STORES, "        if (acc[4 * j + 2 * h] == 1.2345e-30f) o[8 * j] = "
                                         "__float2bfloat16(acc[4 * j + 2 * h + 1]);\n"),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_grouped_matmul: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from petals_tpu_torch.kernels import build as kbuild
    from petals_tpu_torch.ops import grouped_matmul as gm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = os.path.join(REPO, "build", "ablate-grouped")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(kbuild.CSRC_DIR, "grouped_matmul.cu")).read()
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
        if name == "kernel":
            print("\n".join(line.strip() for line in log.splitlines() if "wgmma" in line or "registers" in line
                            or "spill" in line), flush=True)

    device = torch.device("cuda", 0)
    timer = chip_smoke.Timer(device)
    gen = torch.Generator(device=device).manual_seed(chip_smoke.SEED + 23)
    h, m = chip_smoke.MIXTRAL_8X7B["hidden_size"], chip_smoke.MIXTRAL_8X7B["intermediate_size"]
    sizes_t = chip_smoke.GROUPED_SIZES
    E, n = len(sizes_t), sum(sizes_t)
    sizes = torch.tensor(sizes_t, dtype=torch.int32, device=device)
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    for proj, (k_in, k_out) in (("w1", (h, m)), ("w2", (m, h))):
        x = (torch.randn(n, k_in, generator=gen, device=device) * 0.5).to(torch.bfloat16)
        w = (torch.randn(E, k_in, k_out, generator=gen, device=device) * 0.02).to(torch.bfloat16)
        line = [f"{proj} [{E}, {k_in}, {k_out}] over {list(sizes_t)}:"]
        if hasattr(torch, "_grouped_mm"):
            line.append(f"torch._grouped_mm {timer(lambda: torch._grouped_mm(x, w, offs=offs)):.4f} ms;")
        for name, so in libs.items():
            gm._LIB = None  # the wrapper binds whichever library kbuild.load returns
            kbuild.load = lambda _name, so=so: ctypes.CDLL(so)
            line.append(f"{name} {timer(lambda: gm.grouped_matmul(x, w, sizes)):.4f} ms;")
        print(" ".join(line), flush=True)
        del x, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
