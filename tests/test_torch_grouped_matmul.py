"""K7's host side (petals_tpu_torch/ops/grouped_matmul.py) on the CPU: the
kernels' walk of the group sizes and the choice of arm, held to
``jax.lax.ragged_dot``. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 22).

- ``grouped_tiles`` (csrc/grouped_matmul.cu ``tile_slot`` on the host)
  covers every row exactly once, each tile inside one expert's group, in
  group order, and never needs more slots than the grid's ceil(n / BM) + E,
  for empty groups, one full group, sizes at BM - 1, BM and BM + 1 and
  seeded random sizes at E = 8 and E = 64, at both arms' tile heights.
- A float32 product computed tile by tile through ``grouped_tiles`` (each
  tile's rows through its expert's weight, the kernel's decomposition)
  equals ``jax.lax.ragged_dot`` on the same numpy inputs within MOE_ATOL
  (tests/test_torch_mixtral.py's: the same float32 products in another
  order).
- The wrapper's arm is a pure function of x's dtype: bfloat16 the wgmma
  arm, float32 the CUDA-core arm, anything else refused; the source fixes
  one ring configuration, its entry point takes the arguments the wrapper
  binds, and its tile heights are the wrapper's.
- CPU tensors take the plain version and count no launch; tensors on
  another device are refused."""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu_torch.kernels import build as kbuild
from petals_tpu_torch.ops import grouped_matmul as gm
from tests.test_torch_mixtral import MOE_ATOL

SOURCE = (kbuild.CSRC_DIR / "grouped_matmul.cu").read_text()
BMS = sorted(set(gm.TILE_ROWS.values()))


def _edge_cases(bm):
    return [
        (0, 0, 0, 0),
        (5, 0, 0, 3),
        (0, 0, 3 * bm, 0),
        (bm - 1, bm, bm + 1),
        (bm + 1, 0, bm - 1, bm, 1),
        (1,),
    ]


def _random_cases():
    rng = np.random.default_rng(20)
    cases = []
    for n_experts, n in ((8, 1024), (8, 16), (64, 4096), (64, 300)):
        experts = rng.integers(0, n_experts, n)
        cases.append(tuple(np.bincount(experts, minlength=n_experts).tolist()))
    skewed = rng.dirichlet(np.full(8, 0.3)) * 1024
    sizes = np.floor(skewed).astype(int)
    sizes[0] += 1024 - sizes.sum()
    cases.append(tuple(sizes.tolist()))
    return cases


def _check_walk(sizes, bm):
    tiles = gm.grouped_tiles(sizes, bm)
    n, n_experts = sum(sizes), len(sizes)
    assert len(tiles) == -(-n // bm) + n_experts  # one entry a slot of the grid
    live = [t for t in tiles if t is not None]
    assert tiles[: len(live)] == live  # empty slots come last
    covered = np.zeros(n, int)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for expert, start, rows in live:
        assert 0 < rows <= bm
        assert starts[expert] <= start and start + rows <= starts[expert + 1]  # inside its group
        assert rows == bm or start + rows == starts[expert + 1]  # only a group's last tile is ragged
        covered[start : start + rows] += 1
    assert (covered == 1).all()
    assert [t[0] for t in live] == sorted(t[0] for t in live)  # expert after expert
    assert len(live) == sum(-(-g // bm) for g in sizes)
    return live


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("case", range(6))
def test_grouped_tiles_cover_every_row_once_at_the_edges(bm, case):
    _check_walk(_edge_cases(bm)[case], bm)


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("case", range(5))
def test_grouped_tiles_cover_every_row_once_at_random_sizes(bm, case):
    _check_walk(_random_cases()[case], bm)


def test_grouped_tiles_at_the_smokes_routing():
    sizes = (512, 0, 160, 96, 64, 96, 48, 48)
    assert gm.grouped_tiles(sizes, 128) == [
        (0, 0, 128), (0, 128, 128), (0, 256, 128), (0, 384, 128), (2, 512, 128), (2, 640, 32), (3, 672, 96),
        (4, 768, 64), (5, 832, 96), (6, 928, 48), (7, 976, 48), None, None, None, None, None,
    ]
    assert len([t for t in gm.grouped_tiles(sizes, 64) if t]) == 18  # the float32 arm's 64-row tiles


@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("sizes", [(0, 5, 0, 3), (8, 0, 0, 0), (63, 64, 65, 1), (2, 2, 2, 2, 130, 0, 1, 70)])
def test_tile_by_tile_product_matches_ragged_dot(bm, sizes):
    rng = np.random.default_rng(sum(sizes) + bm)
    n, k, m = sum(sizes), 24, 40
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = rng.standard_normal((len(sizes), k, m)).astype(np.float32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes, jnp.int32)))
    got = np.full((n, m), np.nan, np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for expert, start, rows in filter(None, gm.grouped_tiles(sizes, bm)):
        # the kernel's tile: bm rows read (past the group: the next group's
        # rows or zeros), only the group's rows stored
        tile = torch.zeros(bm, k)
        avail = min(bm, n - start)
        tile[:avail] = xt[start : start + avail]
        got[start : start + rows] = (tile @ wt[expert]).numpy()[:rows]
    np.testing.assert_allclose(got, want, atol=MOE_ATOL, rtol=0)


def test_kernel_arm_is_chosen_by_dtype():
    assert gm.kernel_arm(torch.bfloat16) == "wgmma"
    assert gm.kernel_arm(torch.float32) == "cuda_cores"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            gm.kernel_arm(dtype)
    assert set(gm.TILE_ROWS) == set(gm.ARMS.values())


def test_source_matches_the_wrapper():
    # the tile heights the walk is taken at; one ring configuration, fixed in the source
    assert f"constexpr int RING_BM = {gm.TILE_ROWS['wgmma']};" in SOURCE
    assert f"constexpr int BM = {gm.TILE_ROWS['cuda_cores']};" in SOURCE
    assert len(re.findall(r"constexpr int TN = \d+;", SOURCE)) == 1
    assert len(re.findall(r"constexpr int STAGES = \d+;", SOURCE)) == 1
    assert "template" not in SOURCE
    # the C entry point takes the ten arguments the wrapper binds: 4 pointers, 5 ints, the stream
    entry = re.search(r"int ptt_grouped_matmul\(([^)]*)\)", SOURCE).group(1)
    assert len(entry.split(",")) == 10
    assert "argtypes = [p] * 4 + [i] * 5 + [p]" in inspect.getsource(gm.kernel_library)
    # both kernels find their tile through one walk, which the source ties to grouped_tiles
    assert SOURCE.count("tile_slot(group_sizes, n_experts, blockIdx.x,") == 2
    assert "grouped_tiles" in SOURCE
    for kernel in ("grouped_matmul_wgmma_kernel", "grouped_matmul_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\([^)]*\) {kernel}\(", SOURCE)
    assert "setmaxnreg" in SOURCE and "cp.async.bulk.tensor" in (kbuild.CSRC_DIR / "hopper_wgmma.cuh").read_text()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    sizes = torch.tensor([3, 0, 5], dtype=torch.int32)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((3, 16, 24)).astype(np.float32)).to(torch.bfloat16)
    gm.reset_launch_counts()
    got = gm.grouped_matmul(x, w, sizes)
    assert torch.equal(got, gm.grouped_matmul_reference(x, w, sizes))
    assert gm.grouped_matmul.launches == 0 and gm.grouped_matmul.arm_launches == {"wgmma": 0, "cuda_cores": 0}
    with pytest.raises(ValueError, match="one CUDA device"):
        gm.grouped_matmul(x.to("meta"), w.to("meta"), sizes.to("meta"))
