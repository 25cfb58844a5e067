#!/usr/bin/env bash
# Time K1, K2, K3 (int8, nf4a) and K4 at chip_smoke.py's Mistral-7B cases
# (check_attention_kernels without the long contexts, check_flash_kernel)
# from two trees in one call on one card, alternated: A, B, B, A. Each tree
# builds its own kernels and is timed with its own chip_smoke.py.
#
#   bash scripts/ab_attention_kernels.sh <tree A> <tree B>
#
# A tree is a checkout unpacked with git archive (for example the parent
# commit into build/parent). Prints one "AB <tree> [(kernel, ms), ...]" line
# a run, then the card's name and power limit.
set -e
for t in "$1" "$2" "$2" "$1"; do
  (cd "$t" && python3 -c "
import torch, chip_smoke as s
s.build()
d = torch.device('cuda', 0); timer = s.Timer(d)
dec, pf = s.attention_cases(d)
ks = s.check_attention_kernels(d, timer, dec, pf, long=False)
kv = [e for k in ('int8', 'nf4a') for e in s.check_attention_kernels(d, timer, dec, pf, k, long=False)]
f = s.check_flash_kernel(d, timer)
print('AB', '$t', [(e['name'], round(e['ms'], 4)) for e in ks + kv + [f]], flush=True)
" 2>&1 | grep -E "^AB|Error|error")
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
