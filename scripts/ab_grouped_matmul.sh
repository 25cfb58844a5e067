#!/usr/bin/env bash
# Time K7, the grouped expert product, at chip_smoke.py's Mixtral-8x7B case
# (check_grouped_matmul: 1024 assignment rows in GROUPED_SIZES through w1
# [8, 4096, 14336] and w2 [8, 14336, 4096], bf16) from two trees in one call
# on one card, alternated: A, B, B, A. Each tree builds its own kernel and is
# timed with its own chip_smoke.py, beside torch._grouped_mm.
#
#   bash scripts/ab_grouped_matmul.sh <tree A> <tree B>
#
# A tree is a checkout unpacked with git archive (for example the parent
# commit into build/parent). Prints one "AB <tree> w1 <ms> w2 <ms> library
# <w1 ms> <w2 ms>" line a run, then the card's name and power limit.
set -e
for t in "$1" "$2" "$2" "$1"; do
  (cd "$t" && python3 -c "
import torch, chip_smoke as s
from petals_tpu_torch.kernels import build
build.build('grouped_matmul')
d = torch.device('cuda', 0)
e = s.check_grouped_matmul(d, s.Timer(d))
print('AB', '$t', 'w1', round(e['ms'], 4), 'w2', round(e['w2']['ms'], 4),
      'library', e['library_ms'] and round(e['library_ms'], 4), e['w2']['library_ms'] and round(e['w2']['library_ms'], 4),
      flush=True)
" 2>&1 | grep -E "^AB|Error|error")
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
