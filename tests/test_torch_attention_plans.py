"""The decode kernel's split plan, and a plain model of its split-and-merge,
on the CPU.

- ``decode_split_plan`` (ops/paged_flash_attention.py) picks how many splits
  the grid has: it covers the card where the lanes' slots allow, one split
  where the lanes alone fill it; pure. ``split_runs`` below is the kernel's
  cut of each lane's needed slots into that many runs: contiguous, ordered,
  every needed slot in exactly one run, a short lane on a wide table spread
  over the splits as a long one is.
- ``split_merge_decode`` below repeats the CUDA decode kernel's arithmetic in
  float32: per split, a partial (m, l, acc) over the split's slots; the
  partials merged in split order. It is held against the plain version
  ``paged_attend`` and the JAX package's Pallas kernel in interpret mode over
  holes, permuted tables, windows, splits left empty, a lane at position 0,
  an idle sentinel lane, groups 1/4/16 and page sizes 16/64/128, on
  floating-point and int8 / nf4a pools. tests/test_torch_kernels_cuda.py
  holds the kernel itself to the plain version on the card.

Tolerance: 2e-5 in float32 (the online softmax and the merge sum in another
order than the one-shot softmax). On a quantized pool the model runs twice:
with the kernels' factoring (scores against raw code values times the row's
scale, the V scale folded into the probabilities), as the Pallas kernel
does, held to it at 2e-5; and over the rows decoded to bfloat16, as
``paged_attend`` decodes them, held to it at 2e-5. Between the two
decodings lies half a bf16 ulp on every K and V value: 2e-2, the bound of
tests/test_torch_kv_quant.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops import paged_attention as J
from petals_tpu.ops.paged_flash_attention import paged_flash_attend as jax_decode
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from petals_tpu_torch.ops.paged_flash_attention import SPLIT_ROWS, decode_split_plan

TOL = 2e-5
KV_QUANT_TOL = 2e-2
H100_SMS = 132

jax_quantize = jax.jit(J.quantize_kv_rows, static_argnums=1)


def split_runs(lane_lo, lane_hi, n_splits):
    """The kernel's cut (csrc/paged_attention.cu, paged_decode_kernel) of the
    slots a lane needs, [lane_lo, lane_hi), into n_splits runs of equal
    length rounded up to SPLIT_ROWS: the last non-empty run shorter, the
    runs after it empty."""
    per = -(-max(0, lane_hi - lane_lo) // (n_splits * SPLIT_ROWS)) * SPLIT_ROWS
    return [(min(lane_hi, lane_lo + s * per), min(lane_hi, lane_lo + (s + 1) * per)) for s in range(n_splits)]


def lane_range(position, capacity, window):
    """The slots a lane at ``position`` needs on a table of ``capacity``."""
    kv_len = position + 1
    return (max(0, kv_len - window) if window else 0), min(kv_len, capacity)


# ------------------------------------------------------------------ decode_split_plan


@pytest.mark.parametrize("n_lanes,hkv,max_pages", [
    (8, 8, 16),  # the kernel phase's 8 lanes, Mistral-7B
    (4, 8, 16),  # the served 4 lanes
    (1, 8, 64),  # one lane at 4k tokens
    (8, 8, 64),  # 8 lanes at 4k tokens
    (1, 1, 1), (3, 2, 7), (64, 8, 16), (40, 8, 128), (2, 1, 1000),
])
@pytest.mark.parametrize("n_sm", [H100_SMS, 1, 16])
def test_decode_split_plan_covers_each_slot_once(n_lanes, hkv, max_pages, n_sm):
    capacity = max_pages * 64  # pages of 64 slots
    n_splits = decode_split_plan(n_lanes, hkv, capacity, n_sm)
    assert n_splits == decode_split_plan(n_lanes, hkv, capacity, n_sm)  # pure
    assert 1 <= n_splits <= -(-capacity // SPLIT_ROWS)
    blocks = n_lanes * hkv * n_splits
    if n_lanes * hkv >= 2 * n_sm:
        assert n_splits == 1  # the lanes alone fill the card: no merge
    else:
        assert blocks <= 2 * n_sm
        # the card is covered where the slots allow: one more split would
        # overshoot two blocks an SM, or leave every lane a run with nothing
        assert n_splits * SPLIT_ROWS >= capacity or n_lanes * hkv * (n_splits + 1) > 2 * n_sm
    # every lane, long or short, windowed or not: runs contiguous and ordered,
    # each needed slot in exactly one, none longer than an even cut needs
    positions = (0, 1, 63, 64, 200, capacity // 3, capacity - 2, capacity - 1, capacity)
    for position in (p for p in positions if p <= capacity):  # the sentinel at capacity
        for window in (None, 100, 4096):
            lo, hi = lane_range(position, capacity, window)
            runs = split_runs(lo, hi, n_splits)
            assert runs[0][0] == lo and runs[-1][1] == hi
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            slots = [t for a, b in runs for t in range(a, b)]
            assert slots == list(range(lo, hi))
            longest = max(b - a for a, b in runs)
            assert longest % SPLIT_ROWS == 0 or longest == hi - lo
            assert longest < -(-(hi - lo) // n_splits) + SPLIT_ROWS


def test_decode_split_plan_at_the_served_shapes():
    # 8 lanes x 8 kv heads at 1024 tokens: 4 splits, 256 blocks
    assert decode_split_plan(8, 8, 1024, H100_SMS) == 4
    # 4 lanes: 8 splits; one lane at 4096 tokens: 33
    assert decode_split_plan(4, 8, 1024, H100_SMS) == 8
    assert decode_split_plan(1, 8, 4096, H100_SMS) == 33
    # one lane of 1024 tokens: one run of 64 slots a split (the slots do not allow 33)
    assert decode_split_plan(1, 8, 1024, H100_SMS) == 16
    # a window caps the slots a lane can need: 200 allow 4 runs
    assert decode_split_plan(1, 8, 200, H100_SMS) == 4
    # 4 lanes on tables of 8192 tokens: 8 splits, and a lane at 1000 tokens
    # is spread over all of them (7 runs of 128 slots and one of 105), not
    # left in one
    n_splits = decode_split_plan(4, 8, 8192, H100_SMS)
    assert n_splits == 8
    assert [b - a for a, b in split_runs(*lane_range(1000, 8192, 4096), n_splits)] == [128] * 7 + [105]
    with pytest.raises(ValueError):
        decode_split_plan(0, 8, 1024, H100_SMS)


@pytest.mark.parametrize("position,capacity,window,n_splits,lengths", [
    (0, 1024, None, 4, [1, 0, 0, 0]),  # a lane at 0: one slot, the other runs empty
    (63, 1024, None, 4, [64, 0, 0, 0]),
    (64, 1024, None, 4, [64, 1, 0, 0]),
    (1023, 1024, None, 4, [256] * 4),
    (1024, 1024, None, 4, [256] * 4),  # the idle sentinel: capped at the table
    (4095, 4096, 4096, 33, [128] * 32 + [0]),  # one lane at 4k: 33 splits, 32 used
    (4095, 4096, 200, 4, [64, 64, 64, 8]),  # the window's 200 slots
    (700, 1024, 200, 4, [64, 64, 64, 8]),
    (150, 1024, 200, 4, [64, 64, 23, 0]),  # shorter than the window
    (999, 8192, 4096, 8, [128] * 7 + [104]),
])
def test_decode_split_runs_spread_each_lane(position, capacity, window, n_splits, lengths):
    lo, hi = lane_range(position, capacity, window)
    runs = split_runs(lo, hi, n_splits)
    assert [b - a for a, b in runs] == lengths
    assert runs[0][0] == lo and runs[-1][1] == hi


# ------------------------------------------------------------------ split-and-merge model


def _rows(pool, flat_rows, kv_head, decode):
    """(values [n, d] float32 as the score / PV products take them, scale [n]
    float32 they are multiplied by) of pool rows ``flat_rows`` (page *
    page_size + offset) of one kv head. A floating-point pool gives its
    values with scale 1. A quantized pool gives, with ``decode="codes"``
    (the kernels' factoring), raw codes (int8) or the unscaled nf4a cubic
    with the row's scale (times NF4A_B); with ``decode="bf16"`` (the plain
    version's), the rows decoded to bfloat16 with scale 1."""
    if not isinstance(pool, T.PagedPool):
        rows = pool.reshape(-1, *pool.shape[2:])[flat_rows, kv_head].float()
        return rows, torch.ones(len(flat_rows))
    codes = pool.codes.reshape(-1, *pool.codes.shape[2:])[flat_rows, kv_head]
    scales = pool.scales.reshape(-1, pool.scales.shape[2])[flat_rows, kv_head].float()
    if decode == "bf16":
        return T.dequantize_kv(codes, scales, pool.kind, torch.bfloat16).float(), torch.ones(len(flat_rows))
    if pool.kind == "int8":
        return codes.float(), scales
    c = codes.to(torch.int32)

    def poly(p):
        dl = p.float() - 7.5
        return dl * (T.NF4A_A / T.NF4A_B + dl * dl)

    return torch.cat([poly(c & 0xF), poly(c >> 4)], dim=-1), scales * T.NF4A_B


def split_merge_decode(q, k_pool, v_pool, tables, positions, n_splits, *,
                       alibi_slopes=None, sliding_window=None, scale=None, decode="codes"):
    """Plain model of the CUDA decode kernel: each split's float32 partial
    (m, l, acc) over its run of slots (``split_runs``), then the merge in
    split order; a quantized pool's rows as ``_rows`` decodes them."""
    n_lanes, _, hq, d = q.shape
    n_pages, ps, hkv = k_pool.shape[:3]
    group, max_pages = hq // hkv, tables.shape[1]
    scale = d**-0.5 if scale is None else scale
    out = torch.zeros(n_lanes, 1, hq, d)
    for lane in range(n_lanes):
        runs = split_runs(*lane_range(int(positions[lane]), max_pages * ps, sliding_window), n_splits)
        for h in range(hkv):
            heads = slice(h * group, (h + 1) * group)
            qh = q[lane, 0, heads].float()  # [group, d]
            parts = []
            for first, end in runs:
                slots = torch.arange(first, end)
                pages = tables[lane, (slots // ps).long()] if len(slots) else slots
                ok = (pages >= 0) & (pages < n_pages)
                slots, flat = slots[ok], (pages[ok] * ps + slots[ok] % ps).long()
                if len(slots) == 0:
                    parts.append((DEFAULT_MASK_VALUE, torch.zeros(group), torch.zeros(group, d)))
                    continue
                kv, ks = _rows(k_pool, flat, h, decode)
                vv, vs = _rows(v_pool, flat, h, decode)
                sc = (qh @ kv.T) * (ks * scale)
                if alibi_slopes is not None:
                    sc = sc + alibi_slopes[heads, None].float() * slots.float()
                m = sc.amax(dim=1)
                e = torch.exp(sc - m[:, None])
                parts.append((m, e.sum(dim=1), (e * vs) @ vv))
            live = [p for p in parts if not isinstance(p[0], float)]
            if not live:
                continue  # no slot at all: exact zeros
            big_m = torch.stack([p[0] for p in live]).amax(dim=0)
            big_l, acc = torch.zeros(group), torch.zeros(group, d)
            for m, l, a in parts:  # split order
                if isinstance(m, float):
                    continue
                w = torch.exp(m - big_m)
                big_l, acc = big_l + w * l, acc + w[:, None] * a
            out[lane, 0, heads] = acc / big_l.clamp_min(1e-30)[:, None]
    return out


def _case(rng, n_lanes, group, ps, d, kinds):
    """Seeded inputs: lanes at 0, mid-page, a page edge and deep, holes past
    each frontier on a permuted table, and an idle sentinel lane whose table
    is all holes (positions at the table's capacity)."""
    hkv = 2 if group < 16 else 1
    max_pages = 320 // ps + 1
    capacity = max_pages * ps
    pos = np.array([0, ps // 2, ps - 1, ps, capacity - 5, capacity][:n_lanes], np.int32)
    n_pages = n_lanes * max_pages + 3
    tables = np.full((n_lanes, max_pages), -1, np.int32)
    free = list(rng.permutation(n_pages))
    for lane in range(n_lanes - 1):  # the last lane idles
        for slot in range(-(-int(pos[lane] + 1) // ps)):
            tables[lane, slot] = free.pop()
    q = rng.standard_normal((n_lanes, 1, hkv * group, d)).astype(np.float32)
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    pools = []
    for _ in range(2):
        rows = rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32)
        if kinds == "none":
            pools.append((jnp.asarray(rows), torch.from_numpy(rows)))
        else:
            codes, scales = jax_quantize(jnp.asarray(rows), kinds)
            pools.append((J.PagedPool(codes, scales),
                          T.PagedPool(torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scales)))))
    return q, pools, tables, pos, slopes


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
@pytest.mark.parametrize("group,ps", [(1, 16), (4, 64), (16, 128)])
@pytest.mark.parametrize("window", [None, 20])  # 20 < a run: each lane's slots in one run, the others empty
@pytest.mark.parametrize("n_sm", [H100_SMS, 12])  # a run of 64 slots a split; a few longer runs
def test_split_merge_model_matches_plain_and_pallas(kind, group, ps, window, n_sm):
    rng = np.random.default_rng(40 + group + ps)
    n_lanes, d = 6, 32
    q, ((jk, tk), (jv, tv)), tables, pos, slopes = _case(rng, n_lanes, group, ps, d, kind)
    hkv = q.shape[2] // group
    capacity = tables.shape[1] * ps
    plan = decode_split_plan(n_lanes, hkv, min(capacity, window or capacity), n_sm)
    if window is None:
        assert plan == (-(-capacity // SPLIT_ROWS) if n_sm == H100_SMS else 2 * n_sm // (n_lanes * hkv))
    for alibi in (None, slopes):
        kw = dict(sliding_window=window)
        jkw = dict(kw, alibi_slopes=None if alibi is None else jnp.asarray(alibi))
        tkw = dict(kw, alibi_slopes=None if alibi is None else torch.from_numpy(alibi))
        args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tables), torch.from_numpy(pos))
        pallas = np.asarray(jax_decode(jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                                       interpret=True, **jkw))
        plain = T.paged_attend(*args, **tkw)
        for n_splits in (plan, plan + 3):  # the plan's count; more, so every lane has empty runs
            got = split_merge_decode(*args, n_splits, **tkw)
            assert torch.isfinite(got).all()
            assert not got[-1].any()  # the idle lane's table is all holes: exact zeros
            np.testing.assert_allclose(got.numpy(), pallas, atol=TOL, rtol=0)
            # a quantized pool: the same split and merge over the rows decoded
            # as the plain version decodes them (to bfloat16)
            got_bf16_rows = split_merge_decode(*args, n_splits, decode="bf16", **tkw)
            np.testing.assert_allclose(got_bf16_rows.numpy(), plain.float().numpy(), atol=TOL, rtol=0)
            np.testing.assert_allclose(got.numpy(), plain.float().numpy(), atol=KV_QUANT_TOL, rtol=0)


def test_split_merge_model_is_the_same_for_every_plan():
    """The merge is exact up to float32 rounding whatever the split count."""
    rng = np.random.default_rng(50)
    q, ((_, tk), (_, tv)), tables, pos, _ = _case(rng, 6, 4, 16, 32, "none")
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tables), torch.from_numpy(pos))
    for window in (None, 40):
        one = split_merge_decode(*args, 1, sliding_window=window)
        for n_splits in (2, 3, 5, 8):
            np.testing.assert_allclose(split_merge_decode(*args, n_splits, sliding_window=window).numpy(),
                                       one.numpy(), atol=TOL, rtol=0)
