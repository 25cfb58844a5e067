"""The CUDA paged-attention kernels against their plain PyTorch versions on
the card. Every test needs an NVIDIA GPU with nvcc and skips without one.
This file imports neither jax nor petals_tpu, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: in float32 the kernels agree with the plain versions to 2e-5
(online softmax sums in another order); in bf16 the inputs are the same bf16
values, the plain version computes in float32, and the kernel accumulates in
float32 and rounds its output once to bf16: 2e-2 (half a bf16 ulp at
|out| < 4 is 2**-7, plus summation order)."""

import numpy as np
import pytest
import torch

from petals_tpu_torch.ops import paged_flash_attention as pfa
from petals_tpu_torch.ops.paged_attention import paged_attend, paged_prefill_attend

pytestmark = pytest.mark.cuda

CUDA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _holey_permuted(rng, n_lanes, max_pages, n_pages, used_slots):
    tables = np.full((n_lanes, max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane in range(n_lanes):
        for s in range(used_slots[lane]):
            tables[lane, s] = free.pop()
    return tables


def _on(device, dtype, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("group,d,ps", [(4, 128, 64), (1, 64, 64), (8, 128, 64), (4, 128, 16), (16, 128, 128)])
def test_decode_kernel_matches_plain(cuda_device, dtype, window, group, d, ps):
    rng = np.random.default_rng(10)
    n_lanes, hkv = 5, 2
    max_pages = 384 // ps
    n_pages = n_lanes * max_pages + 10
    kp, vp = rng.standard_normal((2, n_pages, ps, hkv, d)).astype(np.float32)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    pos = np.array([0, 63, 64, 200, max_pages * ps], np.int32)  # the last lane idles at the sentinel
    used = [min(max_pages, -(-int(p + 1) // ps)) for p in pos]
    tables = _holey_permuted(rng, n_lanes, max_pages, n_pages, used)
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    q, kp, vp = _on(cuda_device, dtype, q, kp, vp)
    tables, positions = _on(cuda_device, torch.int32, tables, pos)
    for alibi in (None, torch.from_numpy(slopes).to(cuda_device)):
        before = pfa.paged_flash_attend.launches
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, alibi_slopes=alibi, sliding_window=window)
        torch.cuda.synchronize()
        assert pfa.paged_flash_attend.launches == before + 1
        assert got.dtype == dtype and torch.isfinite(got).all()
        want = paged_attend(q.float(), kp.float(), vp.float(), tables, positions, alibi_slopes=alibi, sliding_window=window)
        err = (got.float() - want)[:4].abs().max().item()
        assert err <= CUDA_TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("chunk_pos,n_valid,window", [(0, 130, None), (64, 100, None), (70, 90, 50), (0, 0, None)])
def test_prefill_kernel_matches_plain(cuda_device, dtype, ps, chunk_pos, n_valid, window):
    rng = np.random.default_rng(11)
    hkv, group, d, chunk = 2, 4, 128, 130
    max_pages = 320 // ps
    n_pages = 2 * max_pages + 4
    kp, vp = rng.standard_normal((2, n_pages, ps, hkv, d)).astype(np.float32)
    q = rng.standard_normal((1, chunk, hkv * group, d)).astype(np.float32)
    # the lane's row is row 1 of a 3-row table with an odd width: a table
    # row need not start 16-byte aligned
    used = max(1, -(-(chunk_pos + n_valid) // ps))
    tables = _holey_permuted(rng, 3, max_pages + 1, n_pages, [0, used, 0])
    slopes = torch.from_numpy((rng.standard_normal(hkv * group) * 0.1).astype(np.float32)).to(cuda_device)
    q, kp, vp = _on(cuda_device, dtype, q, kp, vp)
    (tables,) = _on(cuda_device, torch.int32, tables)
    row = tables[1]
    before = pfa.paged_flash_prefill_attend.launches
    got = pfa.paged_flash_prefill_attend(q, kp, vp, row, chunk_pos, n_valid, alibi_slopes=slopes, sliding_window=window)
    torch.cuda.synchronize()
    assert pfa.paged_flash_prefill_attend.launches == before + 1
    want = paged_prefill_attend(
        q.float(), kp.float(), vp.float(), row, chunk_pos, n_valid, alibi_slopes=slopes, sliding_window=window
    )
    assert torch.isfinite(got).all()
    err = (got.float() - want)[:, :n_valid].abs().max().item() if n_valid else 0.0
    assert err <= CUDA_TOL[dtype], err
    if n_valid == 0:  # no visible position: exact zeros, as the TPU kernel gives
        assert not got.any()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 1, 8, 96, device=cuda_device, dtype=torch.bfloat16)  # head_dim 96
    pool = torch.zeros(4, 64, 2, 96, device=cuda_device, dtype=torch.bfloat16)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        pfa.paged_flash_attend(q, pool, pool, tables, pos)
    q = torch.zeros(2, 1, 8, 128, device=cuda_device, dtype=torch.bfloat16)
    pool = torch.zeros(4, 256, 2, 128, device=cuda_device, dtype=torch.bfloat16)  # page 256
    with pytest.raises(ValueError):
        pfa.paged_flash_attend(q, pool, pool, tables, pos)
    q = torch.zeros(2, 1, 8, 128, device=cuda_device, dtype=torch.float16)
    pool = torch.zeros(4, 64, 2, 128, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        pfa.paged_flash_attend(q, pool, pool, tables, pos)
    with pytest.raises(ValueError):  # a CUDA tensor never falls back to the CPU version
        pfa.paged_flash_attend(q.float().cpu(), pool.float(), pool.float(), tables, pos)
