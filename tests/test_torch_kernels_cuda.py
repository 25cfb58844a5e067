"""The CUDA kernels (paged attention, dense flash attention, dequant-matmul)
against their plain PyTorch versions on the card. Every test needs an NVIDIA GPU with nvcc and skips without one.
This file imports neither jax nor petals_tpu, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: in float32 the kernels agree with the plain versions to 2e-5
(online softmax sums in another order); in bf16 the inputs are the same bf16
values, the plain version computes in float32, and the kernel accumulates in
float32 and rounds its output once to bf16: 2e-2 (half a bf16 ulp at
|out| < 4 is 2**-7, plus summation order). On a quantized pool (K3) 2e-2 for
both query types: the plain version decodes the pool to bf16 values, the
kernel decodes the same codes to float32 registers, so every K and V value
may differ by half a bf16 ulp (tests/test_kv_quant.py uses the same bound).
The bf16 prefill kernel at Mistral-7B's long chunks is held row by row, each
query row within ROW_REL_TOL (bf16 pool) or KV_ROW_REL_TOL (quantized pool)
of its largest output, as chip_smoke.py holds it; both limits are derived in
tests/test_torch_prefill_model.py. Tables with holes where the rows look
check that a hole is seen by no query, as the plain version masks it."""

import numpy as np
import pytest
import torch

from petals_tpu_torch.ops import flash_attention as fa
from petals_tpu_torch.ops import paged_flash_attention as pfa
from petals_tpu_torch.ops import quant_matmul as qmm
from petals_tpu_torch.ops.quant import dequantize, quantize
from petals_tpu_torch.ops.paged_attention import PagedPool, paged_attend, paged_prefill_attend, quantize_kv_rows

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


# (group, head_dim, page size) of the prefill cases: every group the wrapper
# takes a kernel for (up to 16; 3 leaves a packed row idle), every kind of page
# (8 slots: eight pages a 64-slot tile; 128: half a page a tile)
PREFILL_SHAPES = [(4, 128, 64), (4, 128, 16), (4, 128, 128), (4, 64, 64), (1, 64, 8), (2, 128, 16), (3, 128, 64),
                  (8, 64, 128), (16, 128, 8)]
PREFILL_CHUNKS = [(0, 130, None), (64, 100, None), (70, 90, 50), (0, 0, None)]  # (chunk_pos, n_valid, window)


def _prefill_table(rng, ps, max_pages, n_pages, kv_len, holes):
    """Row 1 of a 3-row table with an odd width (a table row need not start
    16-byte aligned): the lane's pages up to kv_len, permuted; with
    ``holes``, its second page and one near the middle of its visible range
    are holes (-1) too, which no query may see."""
    used = max(1, -(-kv_len // ps))
    tables = _holey_permuted(rng, 3, max_pages + 1, n_pages, [0, used, 0])
    if holes:
        tables[1, [min(1, used - 1), used // 2]] = -1
    return tables


def _blind_rows(want, n_valid):
    """Query rows (position, head) among the first n_valid that see nothing:
    exact zeros in the plain version, as the kernels must give them."""
    return want[:, :n_valid].abs().amax(dim=-1) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("group,d,ps", PREFILL_SHAPES)
@pytest.mark.parametrize("chunk_pos,n_valid,window", PREFILL_CHUNKS)
def test_prefill_kernel_matches_plain(cuda_device, dtype, holes, group, d, ps, chunk_pos, n_valid, window):
    rng = np.random.default_rng(11)
    hkv, chunk = 2, 130
    max_pages = 320 // ps
    n_pages = 2 * max_pages + 4
    kp, vp = rng.standard_normal((2, n_pages, ps, hkv, d)).astype(np.float32)
    q = rng.standard_normal((1, chunk, hkv * group, d)).astype(np.float32)
    tables = _prefill_table(rng, ps, max_pages, n_pages, chunk_pos + n_valid, holes)
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
    assert got.dtype == dtype and torch.isfinite(got).all()
    err = (got.float() - want)[:, :n_valid].abs().max().item() if n_valid else 0.0
    assert err <= CUDA_TOL[dtype], err
    # no visible position (n_valid 0, or only holes before it): exact zeros,
    # as the TPU kernel gives
    assert not got[:, :n_valid][_blind_rows(want, n_valid)].any()
    if n_valid == 0:
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


KV_QUANT_TOL = 2e-2


def _quant_pools(device, kind, n_pages, ps, hkv, d, seed):
    """A (k, v) pair of quantized pools, encoded on the card from seeded
    float32 rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        PagedPool(*quantize_kv_rows(torch.randn(n_pages, ps, hkv, d, generator=gen, device=device), kind))
        for _ in range(2)
    )


@pytest.mark.parametrize("kind", ["int8", "nf4a"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("group,d,ps", [(4, 128, 64), (1, 64, 64), (16, 128, 128), (4, 128, 16), (8, 64, 128)])
def test_quantized_decode_kernel_matches_plain(cuda_device, kind, dtype, window, group, d, ps):
    rng = np.random.default_rng(12)
    n_lanes, hkv = 5, 2
    max_pages = 384 // ps
    n_pages = n_lanes * max_pages + 10
    kp, vp = _quant_pools(cuda_device, kind, n_pages, ps, hkv, d, seed=13)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    pos = np.array([0, 63, 64, 200, max_pages * ps], np.int32)  # the last lane idles at the sentinel
    used = [min(max_pages, -(-int(p + 1) // ps)) for p in pos]
    tables = _holey_permuted(rng, n_lanes, max_pages, n_pages, used)
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    (q,) = _on(cuda_device, dtype, q)
    tables, positions = _on(cuda_device, torch.int32, tables, pos)
    for alibi in (None, torch.from_numpy(slopes).to(cuda_device)):
        before, before_fp = dict(pfa.paged_flash_attend.kv_quant_launches), pfa.paged_flash_attend.launches
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, alibi_slopes=alibi, sliding_window=window)
        torch.cuda.synchronize()
        assert pfa.paged_flash_attend.kv_quant_launches[kind] == before[kind] + 1
        assert pfa.paged_flash_attend.launches == before_fp  # never the floating-point arm
        assert got.dtype == dtype and torch.isfinite(got).all()
        want = paged_attend(q.float(), kp, vp, tables, positions, alibi_slopes=alibi, sliding_window=window)
        err = (got.float() - want)[:4].abs().max().item()
        assert err <= KV_QUANT_TOL, err


@pytest.mark.parametrize("kind", ["int8", "nf4a"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("group,d,ps", PREFILL_SHAPES)
@pytest.mark.parametrize("chunk_pos,n_valid,window", PREFILL_CHUNKS)
def test_quantized_prefill_kernel_matches_plain(cuda_device, kind, dtype, holes, group, d, ps, chunk_pos, n_valid,
                                                window):
    rng = np.random.default_rng(14)
    hkv, chunk = 2, 130
    max_pages = 320 // ps
    n_pages = 2 * max_pages + 4
    kp, vp = _quant_pools(cuda_device, kind, n_pages, ps, hkv, d, seed=15)
    q = rng.standard_normal((1, chunk, hkv * group, d)).astype(np.float32)
    tables = _prefill_table(rng, ps, max_pages, n_pages, chunk_pos + n_valid, holes)
    slopes = torch.from_numpy((rng.standard_normal(hkv * group) * 0.1).astype(np.float32)).to(cuda_device)
    (q,) = _on(cuda_device, dtype, q)
    (tables,) = _on(cuda_device, torch.int32, tables)
    row = tables[1]
    before, before_fp = dict(pfa.paged_flash_prefill_attend.kv_quant_launches), pfa.paged_flash_prefill_attend.launches
    got = pfa.paged_flash_prefill_attend(q, kp, vp, row, chunk_pos, n_valid, alibi_slopes=slopes, sliding_window=window)
    torch.cuda.synchronize()
    assert pfa.paged_flash_prefill_attend.kv_quant_launches[kind] == before[kind] + 1
    assert pfa.paged_flash_prefill_attend.launches == before_fp
    want = paged_prefill_attend(q.float(), kp, vp, row, chunk_pos, n_valid, alibi_slopes=slopes, sliding_window=window)
    assert got.dtype == dtype and torch.isfinite(got).all()
    err = (got.float() - want)[:, :n_valid].abs().max().item() if n_valid else 0.0
    assert err <= KV_QUANT_TOL, err
    assert not got[:, :n_valid][_blind_rows(want, n_valid)].any()
    if n_valid == 0:
        assert not got.any()


# bf16 prefill held row by row, relative to each query row's largest output
# (tests/test_torch_prefill_model.py derives both): the kernel rounds P and
# its output to bf16, 2**-7 of the row on a bf16 pool; a quantized pool adds a
# bf16 decode of every K and V value on each side, 2**-5
ROW_REL_TOL = 2**-7
KV_ROW_REL_TOL = 2**-5


def _long_chunk(device, kind, chunk_pos, table_tokens, seed):
    """Mistral-7B's heads (32 over 8, head_dim 128, page 64): a 512-row chunk
    at ``chunk_pos`` on a permuted table of ``table_tokens`` tokens, pages up
    to the chunk's end allocated, three pages inside the visible range holes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    max_pages, kv_len = table_tokens // 64, chunk_pos + 512
    used = kv_len // 64
    n_pages = max_pages + 3
    row = torch.full((max_pages,), -1, dtype=torch.int32)
    row[:used] = torch.randperm(n_pages, generator=torch.Generator().manual_seed(seed))[:used].to(torch.int32)
    row[[used // 5, used // 2, used - 12]] = -1
    if kind == "none":
        kp, vp = (torch.randn(n_pages, 64, 8, 128, generator=gen, device=device).to(torch.bfloat16) for _ in range(2))
    else:
        kp, vp = _quant_pools(device, kind, n_pages, 64, 8, 128, seed=seed + 1)
    q = torch.randn(1, 512, 32, 128, generator=gen, device=device).to(torch.bfloat16)
    return q, kp, vp, row.to(device)


def _row_ratio(got, want):
    """Worst, over query rows (position, head), of the row's max abs error
    over its largest |want|."""
    return ((got.float() - want).abs().amax(dim=-1) / want.abs().amax(dim=-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
@pytest.mark.parametrize("chunk_pos,table_tokens", [(3584, 4096), (4608, 8192)])
def test_prefill_kernels_at_long_chunks(cuda_device, kind, chunk_pos, table_tokens):
    """The long chunks of a 4096-token prompt and of an 8192-token table
    under Mistral-7B's window of 4096, with holes where the rows look; each
    query row within its limit of its largest output."""
    q, kp, vp, row = _long_chunk(cuda_device, kind, chunk_pos, table_tokens, seed=90)
    got = pfa.paged_flash_prefill_attend(q, kp, vp, row, chunk_pos, 512, sliding_window=4096)
    torch.cuda.synchronize()
    plain = (kp.float(), vp.float()) if kind == "none" else (kp, vp)
    want = paged_prefill_attend(q.float(), *plain, row, chunk_pos, 512, sliding_window=4096)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    ratio = _row_ratio(got, want)
    assert ratio <= (ROW_REL_TOL if kind == "none" else KV_ROW_REL_TOL), ratio


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_prefill_kernel_is_bit_equal_on_repeats(cuda_device, kind):
    """Each block sums its own rows in a fixed order: repeats give the same bits."""
    q, kp, vp, row = _long_chunk(cuda_device, kind, 3584, 4096, seed=91)
    first = pfa.paged_flash_prefill_attend(q, kp, vp, row, 3584, 500, sliding_window=4096)
    for _ in range(5):
        assert torch.equal(pfa.paged_flash_prefill_attend(q, kp, vp, row, 3584, 500, sliding_window=4096), first)


def test_bf16_prefill_runs_the_wgmma_kernel(cuda_device):
    """A bf16 call launches paged_prefill_wgmma_kernel and counts it; a
    float32 call the CUDA-core paged_prefill_kernel, for every pool kind."""
    from torch.profiler import ProfilerActivity, profile

    def kernel_names(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key for e in prof.key_averages() if "paged_prefill" in e.key}

    for kind in ("none", "int8", "nf4a"):
        q, kp, vp, row = _long_chunk(cuda_device, kind, 448, 1024, seed=92)
        f32 = (kp.float(), vp.float()) if kind == "none" else (kp, vp)
        pfa.reset_launch_counts()
        names = kernel_names(lambda: pfa.paged_flash_prefill_attend(q, kp, vp, row, 448, 512))
        assert names and all("paged_prefill_wgmma_kernel" in n for n in names), names
        names = kernel_names(lambda: pfa.paged_flash_prefill_attend(q.float(), *f32, row, 448, 512))
        assert names and not any("wgmma" in n for n in names) and all("paged_prefill_kernel" in n for n in names)
        counted = pfa.paged_flash_prefill_attend.launches if kind == "none" else \
            pfa.paged_flash_prefill_attend.kv_quant_launches[kind]
        assert counted == 2


def test_wrappers_refuse_bad_quantized_pools(cuda_device):
    q = torch.zeros(2, 1, 8, 128, device=cuda_device, dtype=torch.bfloat16)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda_device)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    k8, v8 = _quant_pools(cuda_device, "int8", 4, 64, 2, 128, seed=16)
    k4, _ = _quant_pools(cuda_device, "nf4a", 4, 64, 2, 128, seed=17)
    with pytest.raises(TypeError):  # one side int8, the other nf4a
        pfa.paged_flash_attend(q, k8, k4, tables, pos)
    with pytest.raises(TypeError):  # one side quantized, the other not
        pfa.paged_flash_attend(q, k8, torch.zeros(4, 64, 2, 128, device=cuda_device, dtype=torch.bfloat16), tables, pos)
    with pytest.raises(TypeError):  # float16 scales
        pfa.paged_flash_attend(q, PagedPool(k8.codes, k8.scales.half()), v8, tables, pos)
    with pytest.raises(ValueError):  # scales of another page size
        pfa.paged_flash_attend(q, PagedPool(k8.codes, k8.scales[:, :32].contiguous()), v8, tables, pos)
    with pytest.raises(ValueError):  # a CUDA pool never falls back to the CPU version
        pfa.paged_flash_attend(q.cpu(), k8, v8, tables.cpu(), pos.cpu())


def _split_case(device, kind, dtype, n_lanes, max_pages, ps, seed):
    """Mistral-7B's heads (32 over 8, head_dim 128) on lanes at 0, mid-page,
    a page edge and deep (up to the table's last slot), holes past each
    frontier on a permuted table, and one idle lane whose table is all holes
    at the sentinel position (its output is exact zeros)."""
    rng = np.random.default_rng(seed)
    hkv, group, d = 8, 4, 128
    capacity = max_pages * ps
    pos = np.array([capacity - 1, 0, ps // 2, ps, capacity // 2 + 3][: n_lanes - 1] + [capacity], np.int32)
    n_pages = n_lanes * max_pages + 7
    used = [-(-int(p + 1) // ps) for p in pos[:-1]] + [0]
    tables = _holey_permuted(rng, n_lanes, max_pages, n_pages, used)
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    (q,) = _on(device, dtype, q)
    if kind == "none":
        kp, vp = _on(device, dtype, *rng.standard_normal((2, n_pages, ps, hkv, d)).astype(np.float32))
    else:
        kp, vp = _quant_pools(device, kind, n_pages, ps, hkv, d, seed=seed + 1)
    tables, positions = _on(device, torch.int32, tables, pos)
    return q, kp, vp, tables, positions


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 200])  # 200: most splits of a deep lane see nothing
@pytest.mark.parametrize("n_lanes,max_pages,ps", [(6, 64, 64), (2, 32, 128), (3, 40, 16)])
def test_decode_kernel_over_many_splits(cuda_device, kind, dtype, window, n_lanes, max_pages, ps):
    """Lanes up to 4096 positions: the kernel cuts each lane's needed slots
    into many splits (16 at 2 lanes; a short lane's spread over them as a
    long one's), merged by the last block."""
    q, kp, vp, tables, positions = _split_case(cuda_device, kind, dtype, n_lanes, max_pages, ps, seed=60)
    max_rows = min(max_pages * ps, window or max_pages * ps)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert pfa.decode_split_plan(n_lanes, 8, max_rows, n_sm) > 1
    slopes = torch.from_numpy((np.random.default_rng(61).standard_normal(32) * 0.05).astype(np.float32)).to(cuda_device)
    for alibi in (None, slopes):
        pfa.reset_launch_counts()
        got = pfa.paged_flash_attend(q, kp, vp, tables, positions, alibi_slopes=alibi, sliding_window=window)
        torch.cuda.synchronize()
        counted = pfa.paged_flash_attend.launches if kind == "none" else pfa.paged_flash_attend.kv_quant_launches[kind]
        assert counted == 1  # one launch however many splits
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert not got[-1].any()  # the idle lane: no page at all, exact zeros
        want = paged_attend(q.float(), kp.float() if kind == "none" else kp, vp.float() if kind == "none" else vp,
                            tables, positions, alibi_slopes=alibi, sliding_window=window)
        err = (got.float() - want)[:-1].abs().max().item()
        assert err <= (CUDA_TOL[dtype] if kind == "none" else KV_QUANT_TOL), err


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_decode_split_merge_is_bit_equal_on_repeats(cuda_device, kind):
    """The last block to arrive merges the partials in split order, so which
    block that is does not change a bit; the arrival counters return to zero."""
    q, kp, vp, tables, positions = _split_case(cuda_device, kind, torch.bfloat16, 6, 64, 64, seed=62)
    first = pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=4096)
    for _ in range(5):
        assert torch.equal(pfa.paged_flash_attend(q, kp, vp, tables, positions, sliding_window=4096), first)
    torch.cuda.synchronize()
    assert not any(buf.any() for buf in pfa._TICKETS.values())


def test_attention_launch_counters_count_each_call(cuda_device):
    q, kp, vp, tables, positions = _split_case(cuda_device, "none", torch.bfloat16, 2, 32, 128, seed=63)
    k8, v8 = _quant_pools(cuda_device, "int8", kp.shape[0], 128, 8, 128, seed=64)
    pfa.reset_launch_counts()
    fa.reset_launch_counts()
    for calls in (1, 2, 3):
        pfa.paged_flash_attend(q, kp, vp, tables, positions)
        assert pfa.paged_flash_attend.launches == calls
    pfa.paged_flash_attend(q, k8, v8, tables, positions)
    assert pfa.paged_flash_attend.launches == 3 and pfa.paged_flash_attend.kv_quant_launches == {"int8": 1, "nf4a": 0}
    qc = torch.randn(1, 40, 32, 128, device=cuda_device, dtype=torch.bfloat16)
    kc = torch.randn(1, 64, 8, 128, device=cuda_device, dtype=torch.bfloat16)
    for calls in (1, 2):
        fa.flash_attend(qc, kc, kc, kv_length=40)
        assert fa.flash_attend.launches == calls
    assert pfa.paged_flash_prefill_attend.launches == 0


QUANT_REL_TOL = 1e-2
# Mistral-7B's projections as the port serves them (qkv and gate+up fused),
# and (192, 80): rows padded to the stored 1024 (filled with garbage here,
# which the kernels must ignore) and a partial 128-column tile
QUANT_SHAPES = {
    "wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672), "wd": (14336, 4096), "padded": (192, 80),
}
# decode rows (<= 32, around the decode kernel's 8-row tiles of x and the
# m16 edges), then the main path's chunk lengths and the prefill kernel's
# tile edges around them (64-row sub-tiles, 128- and 256-row tiles)
QUANT_ROWS = [1, 4, 8, 16, 17, 32, 33, 64, 65, 188, 300, 512, 516, 1024]
_QUANT_WEIGHTS = {}


def _quant_weight(device, kind, shape_name):
    """A seeded weight of ``kind`` at one of QUANT_SHAPES, quantized on the
    card once per run; the padded shape's stored rows past K hold garbage."""
    key = (kind, shape_name)
    if key not in _QUANT_WEIGHTS:
        k, n = QUANT_SHAPES[shape_name]
        gen = torch.Generator(device=device).manual_seed(20 + len(_QUANT_WEIGHTS))
        w = quantize((torch.randn(k, n, generator=gen, device=device) * 0.02).to(torch.bfloat16), kind)
        if shape_name == "padded":
            rows = k if kind == "int8" else k // 2
            w.data[rows:] = torch.randint(-128 if kind == "int8" else 0, 128 if kind == "int8" else 256,
                                          w.data[rows:].shape, generator=gen, device=device).to(w.data.dtype)
            if kind != "int8":
                w.scales[k // 64:] = 1e3
        _QUANT_WEIGHTS[key] = w
    return _QUANT_WEIGHTS[key]


@pytest.mark.parametrize("kind", ["nf4", "nf4a", "int4", "int8"])
@pytest.mark.parametrize("m", QUANT_ROWS)
@pytest.mark.parametrize("shape_name", list(QUANT_SHAPES))
def test_dequant_matmul_kernels_match_plain(cuda_device, kind, m, shape_name):
    w = _quant_weight(cuda_device, kind, shape_name)
    k, n = QUANT_SHAPES[shape_name]
    gen = torch.Generator(device=cuda_device).manual_seed(20 + m)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    wrapper = qmm.quant_decode_matmul if m <= 32 else qmm.quant_prefill_matmul
    before = dict(wrapper.launches)
    got = qmm.dequant_matmul(x, w)
    torch.cuda.synchronize()
    assert wrapper.launches[kind] == before[kind] + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n) and torch.isfinite(got).all()
    want = x.float() @ dequantize(w, torch.bfloat16).float()
    err = (got.float() - want).abs().max().item()
    assert err <= QUANT_REL_TOL * want.abs().max().item(), (err, want.abs().max().item())
    # an f32 caller gets f32 back, computed on the same bf16-rounded x
    got32 = qmm.dequant_matmul(x.float(), w)
    assert got32.dtype == torch.float32 and torch.equal(got32, got.float())


@pytest.mark.parametrize("kind", ["nf4a", "int8"])
@pytest.mark.parametrize("m,shape_name", [(188, "wo"), (188, "wd"), (512, "wgu"), (65, "wqkv")])
def test_prefill_kernel_is_deterministic(cuda_device, kind, m, shape_name):
    """Two calls give bit-equal outputs: split-K partials are added in split
    order, never by atomics."""
    w = _quant_weight(cuda_device, kind, shape_name)
    k, n = QUANT_SHAPES[shape_name]
    plan = qmm.prefill_plan(m, k, n, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    assert shape_name not in ("wo", "wd") or plan.k_splits > 1  # the split path is the one in question
    x = torch.randn(m, k, generator=torch.Generator(device=cuda_device).manual_seed(7), device=cuda_device)
    first = qmm.quant_prefill_matmul(x.to(torch.bfloat16), w)
    second = qmm.quant_prefill_matmul(x.to(torch.bfloat16), w)
    assert torch.equal(first, second)


@pytest.mark.parametrize("kind", ["nf4a", "int8"])
@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("shape_name", ["wo", "wd", "wqkv"])
def test_decode_kernel_is_deterministic(cuda_device, kind, m, shape_name):
    """Two calls give bit-equal outputs where the decode kernel cuts column
    slabs between blocks: the last block to arrive adds the float32 partials
    in K order, whichever block that is."""
    w = _quant_weight(cuda_device, kind, shape_name)
    k, n = QUANT_SHAPES[shape_name]
    plan = qmm.decode_plan(m, k, n, torch.cuda.get_device_properties(cuda_device).multi_processor_count, kind)
    assert any(qmm.decode_contributors(plan, s)[1] > qmm.decode_contributors(plan, s)[0]
               for s in range(plan.n_slabs))  # the merge path is the one in question
    x = torch.randn(m, k, generator=torch.Generator(device=cuda_device).manual_seed(7), device=cuda_device)
    first = qmm.quant_decode_matmul(x.to(torch.bfloat16), w)
    second = qmm.quant_decode_matmul(x.to(torch.bfloat16), w)
    assert torch.equal(first, second)


@pytest.mark.parametrize("kind", ["nf4", "nf4a", "int4", "int8"])
@pytest.mark.parametrize("m", [1, 8, 17, 32])
def test_decode_kernel_stream_k_deal_matches_plain(cuda_device, kind, m):
    """92 slabs fill too few of the SMs for a slab-aligned grid: one block
    per SM, whose runs cut up to two slabs each (partial slots 0 and 1 in
    the merge), held to the plain version and bit-equal on a repeat."""
    k, n = 1024, 92 * 256
    gen = torch.Generator(device=cuda_device).manual_seed(40 + m)
    w = quantize((torch.randn(k, n, generator=gen, device=cuda_device) * 0.02).to(torch.bfloat16), kind)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = qmm.decode_plan(m, k, n, n_sm, kind)
    assert plan.ctas == min(n_sm, plan.n_slabs * plan.n_kb) and plan.ctas % plan.n_slabs != 0
    assert any(len(qmm.decode_segments(plan, c)) == 2 for c in range(plan.ctas))
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    got = qmm.quant_decode_matmul(x, w)
    want = x.float() @ dequantize(w, torch.bfloat16).float()
    assert (got.float() - want).abs().max().item() <= QUANT_REL_TOL * want.abs().max().item()
    assert torch.equal(qmm.quant_decode_matmul(x, w), got)


def test_decode_launch_counter_counts_each_call(cuda_device):
    """One launch a call, on a shape whose slabs are merged inside the
    launch (no second kernel)."""
    w = _quant_weight(cuda_device, "int4", "wd")
    x = torch.randn(4, QUANT_SHAPES["wd"][0], device=cuda_device, dtype=torch.bfloat16)
    before, before_prefill = dict(qmm.quant_decode_matmul.launches), dict(qmm.quant_prefill_matmul.launches)
    for calls in (1, 2, 3):
        qmm.quant_decode_matmul(x, w)
        assert qmm.quant_decode_matmul.launches["int4"] == before["int4"] + calls
    assert {k: v for k, v in qmm.quant_decode_matmul.launches.items() if k != "int4"} == {
        k: v for k, v in before.items() if k != "int4"}
    assert qmm.quant_prefill_matmul.launches == before_prefill


def test_prefill_launch_counter_counts_each_call(cuda_device):
    w = _quant_weight(cuda_device, "nf4", "padded")
    x = torch.randn(100, 192, device=cuda_device, dtype=torch.bfloat16)
    before = dict(qmm.quant_prefill_matmul.launches)
    for calls in (1, 2, 3):
        qmm.quant_prefill_matmul(x, w)
        assert qmm.quant_prefill_matmul.launches["nf4"] == before["nf4"] + calls
    assert {k: v for k, v in qmm.quant_prefill_matmul.launches.items() if k != "nf4"} == {
        k: v for k, v in before.items() if k != "nf4"}


def test_dequant_matmul_refuses_what_the_kernels_do_not_take(cuda_device):
    w = quantize(torch.randn(128, 256, device=cuda_device), "nf4a")
    x = torch.randn(4, 128, device=cuda_device)
    with pytest.raises(ValueError):  # a CUDA weight never falls back to the CPU version
        qmm.dequant_matmul(x.cpu(), w)
    with pytest.raises(ValueError):
        qmm.dequant_matmul(x[:, :64], w)
    odd = quantize(torch.randn(128, 72, device=cuda_device), "int8")  # out_features % 16
    with pytest.raises(ValueError):
        qmm.dequant_matmul(x, odd)


# ---- K4: dense-buffer flash attention (csrc/flash_attention.cu)
#
# Tolerance as above: 2e-5 in float32; in bf16 the plain version rounds the
# probabilities to bf16 as the kernel does, relative to the row's final max
# where the kernel rounds relative to its running max, so a probability may
# land one bf16 ulp apart, inside the same 2e-2.


def _stacked_cache(rng, device, dtype, n_blocks, batch, buf, hkv, d):
    """(k_stack, v_stack) [n_blocks, batch, buf, hkv, d]: a private session's
    cache; block i's buffers are the strided views stack[i]."""
    return _on(device, dtype, *rng.standard_normal((2, n_blocks, batch, buf, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,d", [(4, 128), (1, 64), (8, 128), (16, 64)])
@pytest.mark.parametrize("batch,q_len,buf,q_offset,window", [
    (1, 130, 256, 0, None),  # offset 0, a ragged last tile
    (2, 70, 200, 90, None),  # continuation; a buffer that is no multiple of 128 or of the tile
    (2, 200, 333, 40, 50),  # window: tiles before it are never read
    (1, 8, 77, 60, 4096),  # the smallest chunk the dispatch sends here
    (3, 64, 64, 0, 1),  # every row sees itself only
])
def test_flash_kernel_matches_plain(cuda_device, dtype, group, d, batch, q_len, buf, q_offset, window):
    rng = np.random.default_rng(30)
    hkv = 2
    k_stack, v_stack = _stacked_cache(rng, cuda_device, dtype, 3, batch, buf, hkv, d)
    (q,) = _on(cuda_device, dtype, rng.standard_normal((batch, q_len, hkv * group, d)).astype(np.float32))
    slopes = torch.from_numpy((rng.standard_normal(hkv * group) * 0.1).astype(np.float32)).to(cuda_device)
    k, v = k_stack[1], v_stack[1]
    kv_length = q_offset + q_len
    for alibi in (None, slopes):
        before = fa.flash_attend.launches
        got = fa.flash_attend(q, k, v, q_offset=q_offset, kv_length=kv_length, alibi_slopes=alibi, sliding_window=window)
        torch.cuda.synchronize()
        assert fa.flash_attend.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous() and torch.isfinite(got).all()
        want = fa.flash_attend_reference(
            q, k, v, q_offset=q_offset, kv_length=kv_length, alibi_slopes=alibi, sliding_window=window
        )
        err = (got.float() - want.float()).abs().max().item()
        assert err <= CUDA_TOL[dtype], err


@pytest.mark.parametrize("group,d", [(1, 128), (2, 64), (3, 128), (4, 128), (8, 64), (16, 128)])
@pytest.mark.parametrize("batch,q_len,buf,q_offset,window", [
    (1, 511, 600, 0, None),  # interior tiles below the diagonal, a ragged last query tile
    (2, 300, 1100, 700, 256),  # continuation with a window: tiles before it never read
    (1, 97, 250, 153, None),  # buffer and offset no multiple of the tile
    (2, 40, 40, 0, 7),  # narrow window: every tile an edge tile
])
def test_flash_wgmma_kernel_matches_plain(cuda_device, group, d, batch, q_len, buf, q_offset, window):
    """bf16 on the wgmma kernel: the GQA group packed into a block's 64 rows
    (a group of 3 leaves a row idle), masks on edge tiles only, strided views
    of a stacked cache, ALiBi."""
    rng = np.random.default_rng(34)
    hkv = 2
    k_stack, v_stack = _stacked_cache(rng, cuda_device, torch.bfloat16, 2, batch, buf, hkv, d)
    (q,) = _on(cuda_device, torch.bfloat16, rng.standard_normal((batch, q_len, hkv * group, d)).astype(np.float32))
    slopes = torch.from_numpy((rng.standard_normal(hkv * group) * 0.05).astype(np.float32)).to(cuda_device)
    k, v = k_stack[1], v_stack[1]
    kv_length = min(buf, q_offset + q_len)
    for alibi in (None, slopes):
        got = fa.flash_attend(q, k, v, q_offset=q_offset, kv_length=kv_length, alibi_slopes=alibi, sliding_window=window)
        torch.cuda.synchronize()
        want = fa.flash_attend_reference(q, k, v, q_offset=q_offset, kv_length=kv_length, alibi_slopes=alibi,
                                         sliding_window=window)
        assert got.shape == q.shape and torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= CUDA_TOL[torch.bfloat16], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_strided_views(cuda_device, dtype):
    """q sliced out of a fused qkv row, k/v a lane of a dense pool and a block
    of a stacked cache: read through their strides, equal to contiguous copies."""
    rng = np.random.default_rng(31)
    hq, hkv, d, n = 8, 2, 128, 100
    (qkv,) = _on(cuda_device, dtype, rng.standard_normal((2, n, (hq + 2 * hkv) * d)).astype(np.float32))
    q = qkv[..., : hq * d].reshape(2, n, hq, d)
    assert not q.is_contiguous()
    k_pool, v_pool = _stacked_cache(rng, cuda_device, dtype, 2, 4, 160, hkv, d)  # [blocks, lanes, L, hkv, d]
    for k, v, qq in ((k_pool[1, 1:3], v_pool[1, 1:3], q), (k_pool[:, 2:3][0], v_pool[:, 2:3][0], q[1:])):
        got = fa.flash_attend(qq, k, v, q_offset=30, kv_length=30 + n, sliding_window=64)
        want = fa.flash_attend(qq.contiguous(), k.contiguous(), v.contiguous(), q_offset=30, kv_length=30 + n, sliding_window=64)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        ref = fa.flash_attend_reference(qq, k, v, q_offset=30, kv_length=30 + n, sliding_window=64)
        assert (got.float() - ref.float()).abs().max().item() <= CUDA_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rows_that_see_nothing_are_exact_zeros(cuda_device, dtype):
    rng = np.random.default_rng(32)
    q, k, v = _on(cuda_device, dtype, *(rng.standard_normal(s).astype(np.float32)
                                         for s in ((2, 80, 8, 128), (2, 96, 2, 128), (2, 96, 2, 128))))
    got = fa.flash_attend(q, k, v, kv_length=0)
    assert not got.any()
    # the chunk overruns kv_length with a window: rows at 68 and later see (pos - 4, pos] beyond 64
    got = fa.flash_attend(q, k, v, q_offset=60, kv_length=64, sliding_window=4)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and not got[:, 8:].any() and got[:, :4].any()
    want = fa.flash_attend_reference(q, k, v, q_offset=60, kv_length=64, sliding_window=4)
    assert (got.float() - want.float()).abs().max().item() <= CUDA_TOL[dtype]


def test_attend_dispatches_dense_chunks_to_the_flash_kernel(cuda_device):
    from petals_tpu_torch.ops.attention import attend, attend_reference

    rng = np.random.default_rng(33)
    q, k, v = _on(cuda_device, torch.bfloat16, *(rng.standard_normal(s).astype(np.float32)
                                                  for s in ((2, 40, 8, 128), (2, 96, 2, 128), (2, 96, 2, 128))))
    pfa.reset_launch_counts()
    fa.reset_launch_counts()
    out = attend(q, k, v, q_offset=5, kv_length=45, use_flash=True)
    assert fa.flash_attend.launches == 1
    ref = attend_reference(q, k, v, q_offset=5, kv_length=45)
    assert (out.float() - ref.float()).abs().max().item() <= CUDA_TOL[torch.bfloat16]
    attend(q[:, :7], k, v, q_offset=5, kv_length=12, use_flash=True)  # a decode shape
    attend(q, k, v, q_offset=5, kv_length=45, use_flash=False)
    positions = torch.tensor([5, 9], dtype=torch.int32, device=cuda_device)
    attend(q[:, :1], k, v, q_offset=positions, kv_length=positions + 1, use_flash=True)  # per-lane positions
    assert fa.flash_attend.launches == 1
    assert pfa.paged_flash_attend.launches == pfa.paged_flash_prefill_attend.launches == 0


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, device=cuda_device, dtype=dtype)

    with pytest.raises(ValueError):  # head_dim 96
        fa.flash_attend(z(1, 8, 4, 96), z(1, 16, 2, 96), z(1, 16, 2, 96))
    with pytest.raises(TypeError):  # float16
        fa.flash_attend(z(1, 8, 4, 128, dtype=torch.float16), z(1, 16, 2, 128, dtype=torch.float16), z(1, 16, 2, 128, dtype=torch.float16))
    with pytest.raises(TypeError):  # a cache of another type than q
        fa.flash_attend(z(1, 8, 4, 128), z(1, 16, 2, 128, dtype=torch.float32), z(1, 16, 2, 128, dtype=torch.float32))
    with pytest.raises(ValueError):  # 5 query heads over 2 kv heads
        fa.flash_attend(z(1, 8, 5, 128), z(1, 16, 2, 128), z(1, 16, 2, 128))
    with pytest.raises(ValueError):  # kv_length beyond the buffer
        fa.flash_attend(z(1, 8, 4, 128), z(1, 16, 2, 128), z(1, 16, 2, 128), kv_length=17)
    with pytest.raises(ValueError):  # the head dim must be contiguous
        fa.flash_attend(z(1, 8, 4, 128), z(1, 16, 128, 2).transpose(2, 3), z(1, 16, 2, 128))
    with pytest.raises(ValueError):  # window 0
        fa.flash_attend(z(1, 8, 4, 128), z(1, 16, 2, 128), z(1, 16, 2, 128), sliding_window=0)
    with pytest.raises(ValueError):  # a CUDA tensor never falls back to the CPU version
        fa.flash_attend(z(1, 8, 4, 128).cpu(), z(1, 16, 2, 128), z(1, 16, 2, 128))
    before = fa.flash_attend.launches
    assert fa.flash_attend(z(1, 0, 4, 128), z(1, 16, 2, 128), z(1, 16, 2, 128)).shape == (1, 0, 4, 128)
    assert fa.flash_attend.launches == before  # nothing to launch


# ------------------------------------------------------------------ step programs (CUDA graphs)


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_prefill_kernel_replays_with_chunk_scalars_read_on_the_card(cuda_device, kind):
    """The prefill kernel reads chunk_pos and n_valid on the card: captured
    once in a CUDA graph, a replay after new values are copied in equals a
    direct call with those values, bit for bit; host integers give the same
    bits as device scalars."""
    rng = np.random.default_rng(31)
    hq, hkv, d, ps, max_pages, q_len = 32, 8, 128, 64, 16, 64
    n_pages = max_pages + 2
    table_row = torch.from_numpy(rng.permutation(n_pages)[:max_pages].astype(np.int32)).to(cuda_device)
    kp, vp = _on(cuda_device, torch.bfloat16, *(rng.standard_normal((n_pages, ps, hkv, d)) for _ in range(2)))
    if kind != "none":
        kp, vp = (PagedPool(*quantize_kv_rows(p, kind)) for p in (kp, vp))
    (q,) = _on(cuda_device, torch.bfloat16, rng.standard_normal((1, q_len, hq, d)))
    scalars = torch.tensor([0, q_len], dtype=torch.int32, device=cuda_device)
    direct = {}
    for pos, n in ((0, 64), (300, 37), (900, 64)):
        direct[pos, n] = pfa.paged_flash_prefill_attend(q, kp, vp, table_row, pos, n, sliding_window=4096)
        cp, nv = pfa.chunk_scalars(pos, n, cuda_device)
        assert torch.equal(pfa.paged_flash_prefill_attend(q, kp, vp, table_row, cp, nv, sliding_window=4096),
                           direct[pos, n])
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        pfa.paged_flash_prefill_attend(q, kp, vp, table_row, scalars[0], scalars[1], sliding_window=4096)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = pfa.paged_flash_prefill_attend(q, kp, vp, table_row, scalars[0], scalars[1], sliding_window=4096)
    for (pos, n), want in direct.items():
        scalars.copy_(torch.tensor([pos, n], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[:, :n], want[:, :n]), (pos, n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_replays_with_positions_read_on_the_card(cuda_device, dtype):
    """K4 reads q_offset and kv_length on the card: captured once in a CUDA
    graph over a strided cache view, a replay after new values are copied in
    equals a direct call with host integers, bit for bit (a padded chunk:
    kv_length = q_offset + its real rows; a kv_length past the buffer is
    clamped to it)."""
    rng = np.random.default_rng(34)
    q, k_stack, v_stack = _on(cuda_device, dtype, rng.standard_normal((2, 64, 8, 128)),
                              *(rng.standard_normal((3, 2, 400, 2, 128)) for _ in range(2)))
    k, v = k_stack[1], v_stack[1]
    cases = ((0, 64), (100, 137), (300, 301), (336, 400))
    direct = {(pos, n): fa.flash_attend(q, k, v, q_offset=pos, kv_length=n, sliding_window=200) for pos, n in cases}
    scalars = torch.tensor([0, 64], dtype=torch.int32, device=cuda_device)
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fa.flash_attend(q, k, v, q_offset=scalars[0], kv_length=scalars[1], sliding_window=200)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fa.flash_attend(q, k, v, q_offset=scalars[0], kv_length=scalars[1], sliding_window=200)
    for (pos, n), want in direct.items():
        scalars.copy_(torch.tensor([pos, n], dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), (pos, n)
    scalars.copy_(torch.tensor([336, 999], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, direct[336, 400])


@pytest.mark.parametrize("quant_type", ["none", "nf4a"])
def test_dense_programs_replay_bit_equal_to_the_eager_loop(cuda_device, quant_type):
    """The dense programs (server/backend.py) against the eager block loop
    of a backend without programs, on clones: a private session's chunks (5
    and 8 rows share the 8 bucket: run eagerly, then captured; 40 padded to
    64), decode steps and decode steps with hypo_ids (each key eager, then
    captured, then replayed), a dense pool's batched decode step and a
    chunk on a lane's view after the pool's warm-up, and the forward:
    outputs and cache bytes bit-equal; K4 counted on every block of every
    padded chunk, replays included."""
    backend = _step_backend(cuda_device, quant_type)
    ref = _step_backend(cuda_device, quant_type)
    ref.block_params = backend.block_params
    for name in ("_dense_decode_program", "_dense_gen_program", "_lane_program", "_private_program",
                 "_private_gen_program", "_forward_program"):
        setattr(ref, name, None)
    hsz, gen = backend.hidden_size, torch.Generator().manual_seed(13)
    cache = tuple(torch.randn(2, 2, 256, 2, 128, generator=torch.Generator(device=cuda_device).manual_seed(3),
                              device=cuda_device).to(torch.bfloat16) for _ in range(2))
    eager = tuple(t.clone() for t in cache)
    fa.reset_launch_counts()
    steps = [(5, 0, None), (8, 5, None), (40, 13, None), (1, 53, None), (1, 54, None), (1, 55, None),
             (1, 56, [1, 0]), (1, 57, [1, 0]), (1, 58, [0, 0])]
    for seq, pos, hypo in steps:
        h = torch.randn(2, seq, hsz, generator=gen)
        hypo = None if hypo is None else torch.tensor(hypo)
        got, _ = backend.inference_step(h, cache, pos, hypo_ids=hypo)
        want, _ = ref.inference_step(h, eager, pos, hypo_ids=hypo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (seq, pos)
        assert all(torch.equal(a, b) for a, b in zip(cache, eager)), (seq, pos)
    c = backend._private_program.counts
    assert (c.eager_calls, c.captures, c.replays, c.anomalies) == (4, 3, 5, 0)
    assert fa.flash_attend.launches == 2 * 2 * 3  # 2 blocks x 3 chunks, program and eager loop
    pool = tuple(torch.randn(2, 3, 256, 2, 128, generator=gen).to(torch.bfloat16).to(cuda_device) for _ in range(2))
    eager_pool = tuple(t.clone() for t in pool)
    backend.warm_dense_programs(pool, 3, 256, 64)
    assert all(torch.equal(a, b) for a, b in zip(pool, eager_pool))  # the warm-up wrote nothing
    positions = torch.tensor([10, 256, 200], dtype=torch.int32)
    for i in range(2):
        h = torch.randn(3, 1, hsz, generator=gen)
        got, _ = backend.batched_decode_step(h, pool, positions + i)
        want, _ = ref.batched_decode_step(h, eager_pool, positions + i)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(pool, eager_pool))
    h = torch.randn(1, 33, hsz, generator=gen)
    got, _ = backend.inference_step(h, backend.dense_lane_view(*pool, 1), 100)
    want, _ = ref.inference_step(h, ref.dense_lane_view(*eager_pool, 1), 100)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(pool, eager_pool))
    x = torch.randn(1, 96, hsz, generator=gen)
    for _ in range(3):
        assert torch.equal(backend.forward(x), ref.forward(x))
    lane = backend._lane_program.counts
    assert lane.captures == 3 * 5 and lane.anomalies == 0  # 3 lanes x buckets 0, 8, 16, 32 and 64


@pytest.mark.parametrize("sampled", [False, True])
def test_private_generation_program_replays_bit_equal_to_the_eager_loop(cuda_device, sampled):
    """``generate_tokens`` on a private cache (server/backend.py: each token
    after the first one replay of the private generation step's program,
    captured on its second step) against a backend without programs on a
    clone: tokens and cache bytes bit-equal, greedy and seeded sampling
    (the seen-token mask updated inside the graph)."""
    backend = _step_backend(cuda_device)
    ref = _step_backend(cuda_device)
    ref.block_params = backend.block_params
    ref._private_gen_program = ref._private_program = None
    cfg = backend.cfg
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    params = {"embed": torch.randn(cfg.vocab_size, cfg.hidden_size, generator=gen, device=cuda_device) * 0.05,
              "norm": torch.ones(cfg.hidden_size, device=cuda_device),
              "head": torch.randn(cfg.hidden_size, cfg.vocab_size, generator=gen, device=cuda_device) * 0.05}
    cache = tuple((torch.randn(2, 1, 128, 2, 128, generator=gen, device=cuda_device) * 0.5).to(torch.bfloat16)
                  for _ in range(2))
    eager = tuple(t.clone() for t in cache)
    last = torch.randn(1, 1, cfg.hidden_size, generator=gen, device=cuda_device).to(torch.bfloat16)
    sampling = {"do_sample": True, "temperature": 0.8, "top_k": 50, "top_p": 0.9, "repetition_penalty": 1.3,
                "seed": 1234, "offset": 0, "context": [5, 9]} if sampled else None
    got, _ = backend.generate_tokens(params, last, cache, 40, 8, sampling=sampling)
    want, _ = ref.generate_tokens(params, last, eager, 40, 8, sampling=sampling)
    torch.cuda.synchronize()
    assert (got == want).all(), (got, want)
    assert all(torch.equal(a, b) for a, b in zip(cache, eager))
    c = backend._private_gen_program.counts
    assert (c.eager_calls, c.captures, c.replays) == (1, 1, 6)


def _step_backend(device, quant_type="none", kv_quant_type="none", n_blocks=2):
    """A 2-block Llama-shaped backend with seeded random bf16 weights at a
    small width (hidden 512, 4 query heads of 128 over 2 kv heads)."""
    from petals_tpu_torch.models.llama.config import LlamaBlockConfig
    from petals_tpu_torch.models.registry import get_family
    from petals_tpu_torch.server.backend import TransformerBackend
    from petals_tpu_torch.utils.convert_block import convert_block_params

    family = get_family("llama")
    cfg = LlamaBlockConfig(hidden_size=512, num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                           intermediate_size=1024, num_hidden_layers=n_blocks, rms_norm_eps=1e-5)
    gen = torch.Generator(device=device).manual_seed(5)
    blocks = []
    for _ in range(n_blocks):
        params = {name: (torch.randn(meta.shape, generator=gen, device=device) * 0.05).to(torch.bfloat16)
                  for name, meta in sorted(family.block_param_shapes(cfg, torch.bfloat16).items())}
        params["ln1"] = params["ln1"] + 1
        params["ln2"] = params["ln2"] + 1
        blocks.append(convert_block_params(params, family.name, quant_type, fuse=True))
    return TransformerBackend(family, cfg, blocks, first_block=0, n_blocks=n_blocks, device=device,
                              quant_type=quant_type, kv_quant_type=kv_quant_type)


@pytest.mark.parametrize("quant_type,kv_quant_type", [("none", "none"), ("none", "int8"), ("none", "nf4a"),
                                                      ("nf4a", "none")])
def test_step_programs_replay_bit_equal_to_the_eager_loop(cuda_device, quant_type, kv_quant_type):
    """Decode and mixed steps replayed as CUDA graphs (server/backend.py)
    against the eager block loop on a clone of the pools: outputs and pool
    bytes bit-equal; one graph per bucket (a 5-token chunk replays the 8
    bucket's graph, 64 the 64 bucket's, each at another lane and position
    than the capture's); the launch counters count the replays' kernels.
    The chunk lane's decode row (at the idle sentinel, read by no caller)
    is held on a replay and left out on the step that captures its bucket:
    the capture's warm-up has run that step once already, so the row, which
    attends the lane's whole table, sees the chunk's rows written."""
    from petals_tpu_torch.ops.paged_attention import PagedPool as Pool
    from petals_tpu_torch.server.backend import bucket_length

    backend = _step_backend(cuda_device, quant_type, kv_quant_type)
    cfg, n_lanes, max_pages, ps = backend.cfg, 3, 8, 64
    bufs = [dsc.make_zeros() for dsc in backend.paged_cache_descriptors(n_lanes * max_pages, ps, 0, 2)]
    replayed = (Pool(bufs[0], bufs[2]), Pool(bufs[1], bufs[3])) if len(bufs) == 4 else tuple(bufs)
    tables = torch.arange(n_lanes * max_pages, dtype=torch.int32).reshape(n_lanes, max_pages)
    gen = torch.Generator().manual_seed(9)
    positions = torch.tensor([3, 100, 250], dtype=torch.int32)

    def clone(pools):
        return tuple(Pool(p.codes.clone(), p.scales.clone()) if isinstance(p, Pool) else p.clone() for p in pools)

    def flat(pools):
        return [t for p in pools for t in (p if isinstance(p, Pool) else (p,))]

    eager = clone(replayed)
    pfa.reset_launch_counts()
    captured = set()
    # (chunk tokens, chunk lane, chunk position), None for a decode step
    for step, chunk_step in enumerate([None, None, (8, 1, 200), (5, 0, 300), (40, 2, 20), (64, 1, 400), None]):
        hidden = torch.randn(n_lanes, 1, cfg.hidden_size, generator=gen)
        h_dev = hidden.to(torch.bfloat16).to(cuda_device)
        if chunk_step is None:
            got = backend.paged_decode_step(hidden, replayed, positions, tables)[:1]
            want = backend._paged_decode_eager(h_dev, eager, positions.to(cuda_device), tables.to(cuda_device))[:1]
        else:
            seq, lane, chunk_pos = chunk_step
            bucket = bucket_length(seq)
            chunk = torch.randn(1, seq, cfg.hidden_size, generator=gen)
            mixed = positions.clone()
            mixed[lane] = max_pages * ps
            padded = torch.zeros(1, bucket, cfg.hidden_size, dtype=torch.bfloat16)
            padded[:, :seq] = chunk.to(torch.bfloat16)
            sc = torch.tensor([lane, chunk_pos, seq], dtype=torch.int32, device=cuda_device)
            dec, out, _ = backend.paged_mixed_step(hidden, replayed, mixed, tables, chunk, lane, chunk_pos)
            w_dec, w_out, _ = backend._paged_mixed_eager(
                h_dev, eager, mixed.to(cuda_device), tables.to(cuda_device), padded.to(cuda_device),
                sc[0:1], sc[1], sc[2])
            rows = [r for r in range(n_lanes) if r != lane or bucket in captured]
            captured.add(bucket)
            got, want = (dec[rows], out), (w_dec[rows], w_out[:, :seq])
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (step, chunk_step)
        assert all(torch.equal(g, w) for g, w in zip(flat(replayed), flat(eager))), (step, chunk_step)
        positions = positions + 1
    stats = backend.step_program_stats()
    assert stats == {"graph_captures": 3, "graph_replays": 7, "graph_anomalies": 0}, stats
    # every step's K1 (decode) and K2 (mixed) ran on both blocks: the eager
    # loop's launches, the warm-ups' and each replay's (the counters count
    # replays, not only the launches a capture made)
    k1 = pfa.paged_flash_attend.launches + sum(pfa.paged_flash_attend.kv_quant_launches.values())
    k2 = pfa.paged_flash_prefill_attend.launches + sum(pfa.paged_flash_prefill_attend.kv_quant_launches.values())
    assert k1 == 2 * (7 + 7 + 3) and k2 == 2 * (4 + 4 + 2), (k1, k2)



def test_sampling_captures_and_replays_bit_equal(cuda_device):
    """``sample_tokens`` at 8 lanes of Mistral-7B's 32000-token vocabulary,
    captured in a CUDA graph (its sorts and cumulative sums included) and
    replayed on fresh inputs: the tokens equal the eager call's."""
    from petals_tpu_torch.ops.sampling import sample_tokens, sampling_tensors, sampling_vectors

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rng = np.random.default_rng(3)

    def inputs():
        vec = sampling_vectors(8, 32000)
        vec["do_sample"][1:] = True
        vec["temperature"][:] = rng.uniform(0.5, 1.5, 8)
        vec["top_k"][2:5] = (1, 50, 40000)
        vec["top_p"][4:] = (0.9, 0.5, 0.95, 1.0)
        vec["repetition_penalty"][[0, 6]] = 1.3
        vec["seen_mask"][:] = rng.random((8, 32000)) < 0.01
        vec["seeds"][:] = rng.integers(0, 2**31, 8)
        vec["draw_idx"][:] = rng.integers(0, 1000, 8)
        logits = torch.randn(8, 32000, generator=gen, device=cuda_device) * 3
        return logits, sampling_tensors(vec, cuda_device)

    logits, samp = inputs()
    static = {"logits": logits.clone(), **{k: v.clone() for k, v in samp.items()}}

    def run():
        return sample_tokens(static["logits"], **{k: v for k, v in static.items() if k != "logits"})

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for _ in range(3):
        logits, samp = inputs()
        static["logits"].copy_(logits)
        for k, v in samp.items():
            static[k].copy_(v)
        graph.replay()
        want = sample_tokens(logits, **samp)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (out, want)


@pytest.mark.parametrize("quant_type,kv_quant_type", [("none", "none"), ("nf4a", "nf4a")])
def test_gen_step_program_replays_bit_equal_to_the_eager_loop(cuda_device, quant_type, kv_quant_type):
    """The generation step (server/backend.py ``paged_gen_decode_step``)
    replayed as a CUDA graph against its eager loop on a clone of the pools:
    hidden states, tokens and pool bytes bit-equal over four steps whose
    lanes generate, decode and idle, greedy and sampled; one capture, and
    K1 ran on both blocks of every replay."""
    from petals_tpu_torch.ops.paged_attention import PagedPool as Pool
    from petals_tpu_torch.ops.sampling import sampling_vectors

    backend = _step_backend(cuda_device, quant_type, kv_quant_type)
    cfg, n_lanes, max_pages, ps = backend.cfg, 4, 8, 64
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    params = {"embed": torch.randn(cfg.vocab_size, cfg.hidden_size, generator=gen, device=cuda_device) * 0.05,
              "norm": torch.ones(cfg.hidden_size, device=cuda_device),
              "head": torch.randn(cfg.hidden_size, cfg.vocab_size, generator=gen, device=cuda_device) * 0.05}
    bufs = [dsc.make_zeros() for dsc in backend.paged_cache_descriptors(n_lanes * max_pages, ps, 0, 2)]
    replayed = (Pool(bufs[0], bufs[2]), Pool(bufs[1], bufs[3])) if len(bufs) == 4 else tuple(bufs)

    def clone(pools):
        return tuple(Pool(p.codes.clone(), p.scales.clone()) if isinstance(p, Pool) else p.clone() for p in pools)

    def flat(pools):
        return [t for p in pools for t in (p if isinstance(p, Pool) else (p,))]

    eager = clone(replayed)
    tables = torch.arange(n_lanes * max_pages, dtype=torch.int32).reshape(n_lanes, max_pages)
    positions = torch.tensor([3, 100, 250, max_pages * ps], dtype=torch.int32)
    use_token = torch.tensor([True, False, True, False])
    tokens = torch.tensor([7, 0, 31999, 0])
    rng = np.random.default_rng(4)
    pfa.reset_launch_counts()
    for step in range(4):
        hidden = torch.randn(n_lanes, 1, cfg.hidden_size, generator=gen, device=cuda_device).cpu()
        vec = sampling_vectors(n_lanes, cfg.vocab_size)
        vec["do_sample"][2] = True
        vec["top_p"][2] = 0.9
        vec["repetition_penalty"][0] = 1.2
        vec["seen_mask"][0] = rng.random(cfg.vocab_size) < 0.05
        vec["seeds"][2], vec["draw_idx"][2] = 12345, step
        got_h, got_t, _ = backend.paged_gen_decode_step(params, hidden, tokens, use_token, replayed, positions,
                                                        tables, sampling_vecs=vec)
        samp = backend._sampling_inputs(vec, cuda_device)
        want_h, want_t = backend._paged_gen_decode_eager(
            params, hidden.to(torch.bfloat16).to(cuda_device), tokens.to(cuda_device), use_token.to(cuda_device),
            eager, positions.to(cuda_device), tables.to(cuda_device), samp)
        torch.cuda.synchronize()
        assert torch.equal(got_h, want_h) and torch.equal(got_t, want_t), step
        assert all(torch.equal(g, w) for g, w in zip(flat(replayed), flat(eager))), step
        tokens = torch.where(use_token, got_t.cpu(), 0)
        positions = positions + torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    assert backend.step_program_stats() == {"graph_captures": 1, "graph_replays": 4, "graph_anomalies": 0}
    k1 = pfa.paged_flash_attend.launches + sum(pfa.paged_flash_attend.kv_quant_launches.values())
    assert k1 == 2 * (4 + 4 + 1), k1  # eager and replayed steps, and the capture's warm-up
