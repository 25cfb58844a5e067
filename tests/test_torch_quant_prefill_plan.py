"""The prefill dequant-matmul kernel's schedule (``prefill_plan`` in
petals_tpu_torch/ops/quant_matmul.py), a pure function of the call's shape
and the card's SM count, held here on the CPU: its tiles cover every output
element once, its K splits cover K once in whole scale blocks, and the
narrow projections leave no SM idle at a short chunk."""

import numpy as np
import pytest

from petals_tpu_torch.ops.quant import NF4_BLOCK
from petals_tpu_torch.ops.quant_matmul import PrefillPlan, prefill_plan

# Mistral-7B's projections as the port serves them (qkv and gate+up fused),
# and a small shape with a partial 128-column tile
SHAPES = {
    "wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672), "wd": (14336, 4096), "small": (192, 80),
}
# the main path's chunk lengths (a mixed step's chunk runs apart from its
# decode rows) and the tile edges around them
ROWS = [33, 64, 65, 188, 300, 512, 516, 1024]
H100_SMS = 132


def _covered_once(n_tiles: int, tile: int, extent: int) -> bool:
    """Whether tiles [i * tile, (i + 1) * tile) clipped to the extent hit
    each index below it exactly once."""
    hits = np.zeros(extent, np.int64)
    for i in range(n_tiles):
        hits[i * tile : min((i + 1) * tile, extent)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tiles_cover_each_output_once(shape, m):
    k, n = SHAPES[shape]
    plan = prefill_plan(m, k, n, H100_SMS)
    rows = 128 * plan.mw
    assert plan.mw in (1, 2)
    # rows and columns each covered once, so every (row, column) once
    assert _covered_once(plan.m_tiles, rows, m) and plan.m_tiles * rows - m < rows
    assert _covered_once(plan.n_tiles, 128, n) and plan.n_tiles * 128 - n < 128
    # the 64-row sub-tiles that issue products (those starting below m):
    # only the last may hold rows past m
    live = sum(1 for t in range(plan.m_tiles * 2 * plan.mw) if 64 * t < m)
    assert live == -(-m // 64)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k_splits_cover_k_once_in_whole_scale_blocks(shape, m):
    k, n = SHAPES[shape]
    plan = prefill_plan(m, k, n, H100_SMS)
    n_kb = k // NF4_BLOCK
    assert plan.k_splits >= 1 and plan.kb_per_split >= 1
    ranges = [(z * plan.kb_per_split, min((z + 1) * plan.kb_per_split, n_kb)) for z in range(plan.k_splits)]
    assert all(lo < hi for lo, hi in ranges)  # no empty split
    hits = np.zeros(n_kb, np.int64)
    for lo, hi in ranges:
        hits[lo:hi] += 1
    assert (hits == 1).all()
    # the kernel's own check (quant_matmul.cu, ptt_quant_matmul_prefill)
    assert (plan.k_splits - 1) * plan.kb_per_split < n_kb


@pytest.mark.parametrize("n_sm", [H100_SMS, 114])
@pytest.mark.parametrize("shape", ["wo", "wd"])
def test_narrow_projections_fill_the_card_at_a_short_chunk(shape, n_sm):
    """wo and wd have 32 column tiles; at 188 rows the tiles alone would
    leave most SMs idle, so K is split until every SM has a block."""
    k, n = SHAPES[shape]
    plan = prefill_plan(188, k, n, n_sm)
    assert plan.k_splits > 1
    assert plan.m_tiles * plan.n_tiles * plan.k_splits >= n_sm


@pytest.mark.parametrize("m", ROWS)
def test_wide_projection_needs_no_split(m):
    """gate+up has 224 column tiles: enough blocks without splitting K, and
    256-row tiles (each decoded weight tile feeding more rows) above 128."""
    plan = prefill_plan(m, *SHAPES["wgu"], H100_SMS)
    assert plan.k_splits == 1
    assert plan.mw == (2 if m > 128 else 1)


def test_plan_is_a_pure_function_of_its_inputs():
    calls = [(m, k, n, sms) for m in ROWS for k, n in SHAPES.values() for sms in (H100_SMS, 114, 16)]
    first = [prefill_plan(*c) for c in calls]
    assert [prefill_plan(*c) for c in reversed(calls)] == first[::-1]
    assert all(isinstance(p, PrefillPlan) for p in first)
