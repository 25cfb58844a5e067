"""chip_smoke.py's phase 20 run b (an nf4a self-draft on a 2-block cut
served with an nf4a pool) at other sampling seeds, on one NVIDIA GPU, to
read how often each sampled stream draws the dense float32 reference's
token (the rule "at least half of a stream's draws", ROADMAP C14):

    python3 scripts/spec_seed_agreement.py [--tree DIR] SEED_A SEED_B

``--tree`` is a checkout whose chip_smoke.py and kernels are used (default:
this repository), for example a parent commit unpacked with git archive.
Builds that tree's kernels, writes chip_smoke.py's seeded checkpoint once
under the tree's build/ and reuses it, then runs the two sampled streams
at SEED_A and SEED_B (SPEC_SAMPLED_NEW draws each, as the smoke's run b;
and the two greedy ones) with the checks and prints
of the smoke, each stream's line naming its agreement count. The last
line is "RESULT PASS" or "RESULT FAIL" with what failed. Run one process
per seed pair.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=REPO)
    parser.add_argument("seeds", type=int, nargs=2)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as smoke

    if not torch.cuda.is_available():
        print("spec_seed_agreement: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    smoke.log(smi)
    os.environ.setdefault("PETALS_TPU_TORCH_CACHE", os.path.join(tree, "build", "throughput-cache"))
    smoke.build()
    ckpt = os.path.join(tree, "build", "spec-seed-ckpt")
    small = os.path.join(ckpt, f"mistral-7b-{smoke.SPEC_DRAFT_BLOCKS}-layers-spec")
    if not os.path.isdir(small):
        os.makedirs(ckpt, exist_ok=True)
        smoke.write_checkpoint(ckpt, device)
        smoke.cut_checkpoint(ckpt, small, smoke.SPEC_DRAFT_BLOCKS)
    smoke.SPEC_SEEDS = tuple(args.seeds)
    common = ("--batch_lanes", str(smoke.SPEC_SESSIONS), "--spec_k", str(smoke.SPEC_K),
              "--draft_window", str(smoke.SPEC_WINDOW))
    label = f"run b at seeds {args.seeds[0]}, {args.seeds[1]}"
    try:
        smoke._spec_run(label, small, smoke.SPEC_DRAFT_BLOCKS, device, smi,
                        ("--draft_model", small, "--kv_quant_type", "nf4a", *common), "nf4a",
                        smoke.SPEC_SAMPLED_NEW)
        print("RESULT PASS", flush=True)
    except AssertionError as e:
        print("RESULT FAIL", e, flush=True)
    sys.stdout.flush()
    os._exit(0)  # the run's server threads are not joined


if __name__ == "__main__":
    sys.exit(main())
