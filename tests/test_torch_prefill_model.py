"""A plain model of the bf16 chunked-prefill kernel's arithmetic
(csrc/paged_attention.cu ``paged_prefill_wgmma_kernel``: K2, and K3's
prefill arms), on the CPU, held to the JAX package's Pallas
``_prefill_kernel`` in interpret mode and to the port's plain
``paged_prefill_attend``.

``wgmma_prefill_model`` repeats what the kernel computes: per kv head,
blocks of ``nwg`` warpgroups, each packing 64 // group query positions x the
group's heads into its 64 rows; the slots from the window's start (rounded
down to a tile) to the causal frontier of the block's last real position,
walked in 64-slot tiles whose rows are read one by one through the table;
rows past the range, on a hole or on a page outside the pool masked out of
the max and the sum; tiles where every row of the warpgroup sees every slot
left unmasked (the model asserts the mask would change nothing there); the
online softmax in the log2 domain; a quantized pool's K scale on the score
row and its V scale folded into P after l has summed it. With the kernel's
roundings (``exact=False``) a quantized tile is decoded to bf16 (int8 codes
exactly, nf4a's unscaled cubic rounded, but nf4a's K as the kernel's bf16
pair: the rounded cubic plus its rounding error rounded) and P is rounded
to bf16 before the PV product; with ``exact=True`` none is rounded.

The cases cover floating-point, int8 and nf4a pools; groups 1, 3, 4 and 16;
pages of 8, 16, 64 and 128 slots; holes inside the visible range; chunks at
position 0 and later; n_valid 0 and n_valid < q_len; a window narrow enough
that whole tiles of a block's range are empty for some warpgroup; ALiBi;
one and two warpgroups a block. Queries and floating-point pools hold
bf16-representable values, as the kernel reads them.

Tolerances:
- EXACT_TOL = 2e-5: the exact model against the Pallas kernel, float32
  both, summed in another order (64-slot tiles, not pages; exp2 of
  log2-scaled scores, not exp).
- ROW_REL_TOL = 2**-7 of each query row's largest output magnitude, on a
  floating-point pool: the model with the kernel's roundings against the
  plain version (float32, P not rounded) and against the Pallas kernel. The
  kernel rounds each probability and each output to bf16, each by at most
  2**-9 of it. The output's rounding moves a row by at most 2**-9 of its
  largest output. P's moves output d by sum_j delta_j p_j v_jd / l with
  independent |delta_j| <= 2**-9: about 2**-9 of the row's largest output
  too, up to ~3x that in a row whose few visible values cancel. Two
  roundings, doubled: 2**-7.
- KV_ROW_REL_TOL = 2**-5, the same on a quantized pool: up to two more bf16
  roundings of every K and V value lie between the two sides (the plain
  version's of each decoded value, the kernel's of nf4a's V cubic), and a
  K value's moves its scores, so every probability, by up to the same
  share. Four roundings, each up to ~3x 2**-9 in a row whose values cancel,
  and K's twice (the score, then the probability): 2**-5.
These are chip_smoke.py's limits for K2 and K3 prefill. At 4000 visible
positions the outputs are ~0.02-0.08, and a dropped 64-slot tile moves them
by ~2e-3: several times K2's limit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops import paged_attention as J
from petals_tpu.ops.paged_flash_attention import paged_flash_attend as jax_decode
from petals_tpu.ops.paged_flash_attention import paged_flash_prefill_attend as jax_prefill
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.ops.attention import DEFAULT_MASK_VALUE

EXACT_TOL = 2e-5
ROW_REL_TOL = 2**-7
KV_ROW_REL_TOL = 2**-5
KV_QUANT_TOL = 2e-2  # a bf16 decode of each K/V value (tests/test_torch_kv_quant.py)
TILE = 64  # kv slots of a tile, packed rows of a warpgroup
LOG2E = 1.4426950408889634

jax_quantize = jax.jit(J.quantize_kv_rows, static_argnums=1)


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def _tile_rows(pool, flat, kv_head, exact, pair=False):
    """(values [64, d] as the products take them, scale [64] they are
    multiplied by) of pool rows ``flat`` of one kv head: a floating-point
    pool's values with scale 1; a quantized pool's raw int8 codes or unscaled
    nf4a cubic (rounded to bf16 unless ``exact``; with ``pair``, K's bf16
    pair, the rounded cubic plus its rounding error rounded) with the row's
    scale times NF4A_B for nf4a. ``flat`` rows of holes were zero-filled:
    index -1."""
    ok = flat >= 0
    idx = flat.clamp_min(0)
    if not isinstance(pool, T.PagedPool):
        rows = pool.reshape(-1, *pool.shape[2:])[idx, kv_head].float()
        return rows * ok[:, None], torch.ones(len(flat))
    codes = pool.codes.reshape(-1, *pool.codes.shape[2:])[idx, kv_head] * ok[:, None]
    scales = pool.scales.reshape(-1, pool.scales.shape[2])[idx, kv_head].float() * ok
    if pool.kind == "int8":
        return codes.float(), scales
    c = codes.to(torch.int32)

    def poly(p):
        dl = p.float() - 7.5
        return dl * (T.NF4A_A / T.NF4A_B + dl * dl)

    vals = torch.cat([poly(c & 0xF), poly(c >> 4)], dim=-1)
    if exact:
        return vals, scales * T.NF4A_B
    rounded = vals.bfloat16().float()
    if pair:
        rounded = rounded + (vals - rounded).bfloat16().float()
    return rounded, scales * T.NF4A_B


def wgmma_prefill_model(q, k_pool, v_pool, table_row, chunk_pos, n_valid, *, alibi_slopes=None,
                        sliding_window=None, scale=None, nwg=1, exact=False, tiles=None):
    """Plain model of the bf16 prefill kernel (see the module docstring);
    ``tiles``, a dict, counts the interior and edge tiles computed."""
    _, q_len, hq, d = q.shape
    n_pages, ps, hkv = k_pool.shape[:3]
    group, max_pages = hq // hkv, table_row.shape[0]
    qp = TILE // group
    kv_len, window = chunk_pos + n_valid, sliding_window or 0
    scale = d**-0.5 if scale is None else scale
    neg = torch.tensor(DEFAULT_MASK_VALUE, dtype=torch.float32)
    slopes = torch.zeros(hq) if alibi_slopes is None else alibi_slopes.float()
    tiles = {} if tiles is None else tiles
    out = torch.zeros(q_len, hq, d)
    for kvh in range(hkv):
        for pos0 in range(0, q_len, nwg * qp):
            p_first = chunk_pos + pos0
            p_last = chunk_pos + min(q_len, pos0 + nwg * qp) - 1
            kv_hi = min(kv_len, p_last + 1, max_pages * ps)
            kv_lo = max(0, p_first - window + 1) if window else 0
            kv_lo -= kv_lo % TILE
            for w in range(nwg):
                first = pos0 + w * qp
                if first >= q_len:
                    continue  # a warpgroup past the chunk: its rows are never written
                positions = torch.arange(first, min(first + qp, q_len))
                heads = kvh * group + torch.arange(group)
                rows = q[0][positions][:, heads].float().reshape(-1, d)  # row m = position * group + head
                q_pos = (chunk_pos + positions).repeat_interleave(group)
                slope = slopes[heads].repeat(len(positions)) * LOG2E
                wg_first, wg_last = chunk_pos + first, chunk_pos + int(positions[-1])
                m = torch.full((len(rows),), DEFAULT_MASK_VALUE)
                l, acc = torch.zeros(len(rows)), torch.zeros(len(rows), d)
                for t0 in range(kv_lo, kv_hi, TILE):
                    slots = t0 + torch.arange(TILE)
                    page = torch.where(slots < kv_hi, table_row[(slots // ps).clamp_max(max_pages - 1)].long(), -1)
                    ok = (page >= 0) & (page < n_pages)
                    flat = torch.where(ok, page * ps + slots % ps, -1)
                    kv, ks = _tile_rows(k_pool, flat, kvh, exact, pair=True)
                    vv, vs = _tile_rows(v_pool, flat, kvh, exact)
                    s = (rows @ kv.T) * (scale * LOG2E * ks)[None] + slope[:, None] * slots.float()[None]
                    seen = ok[None] & (slots[None] <= q_pos[:, None]) & (slots[None] < kv_len)
                    if window:
                        seen &= slots[None] > q_pos[:, None] - window
                    interior = bool(ok.all()) and t0 + TILE - 1 <= wg_first and t0 + TILE <= kv_len and (
                        not window or t0 > wg_last - window)
                    if interior:
                        assert seen.all(), "an interior tile holds a slot some row does not see"
                    else:
                        s = torch.where(seen, s, neg)
                    tiles["interior" if interior else "edge"] = tiles.get("interior" if interior else "edge", 0) + 1
                    m_new = torch.maximum(m, s.amax(dim=1))
                    alpha = torch.exp2(m - m_new)
                    e = torch.where(s == neg, 0.0, torch.exp2(s - m_new[:, None]))
                    l = l * alpha + e.sum(dim=1)
                    p = e * vs[None]
                    if not exact:
                        p = p.bfloat16().float()
                    acc = acc * alpha[:, None] + p @ vv
                    m = m_new
                res = acc / l.clamp_min(1e-30)[:, None]
                out[positions[:, None], heads[None]] = res.reshape(len(positions), group, d)
    return out[None]


def _row_limit_ratio(got, want, rel_tol):
    """Worst, over query rows (position, head), of the row's max abs error
    over ``rel_tol`` x its largest |want|."""
    err = (got - want).abs().amax(dim=-1)
    limit = rel_tol * want.abs().amax(dim=-1)
    return (err / limit.clamp_min(1e-30)).max().item()


def _pools(rng, kind, n_pages, ps, hkv, d):
    """(jax pools, torch pools): bf16-representable float32 rows, or their
    int8 / nf4a encoding by the JAX package's jitted encoder."""
    out = []
    for _ in range(2):
        rows = _bf16(rng.standard_normal((n_pages, ps, hkv, d)).astype(np.float32))
        if kind == "none":
            out.append((jnp.asarray(rows), torch.from_numpy(rows)))
        else:
            codes, scales = jax_quantize(jnp.asarray(rows), kind)
            out.append((J.PagedPool(codes, scales),
                        T.PagedPool(torch.from_numpy(np.array(codes)), torch.from_numpy(np.array(scales)))))
    return out


CHUNK = 40
# (chunk_pos, n_valid, window, holes inside the visible range, alibi)
CASES = [
    (0, CHUNK, None, False, False),  # a chunk at position 0
    (130, 33, None, True, True),  # later, n_valid < q_len, holes where the rows look
    (130, CHUNK, None, False, False),  # later, no holes: tiles below the diagonal are interior
    (100, CHUNK, 9, True, False),  # a narrow window: whole tiles of a block's range empty
    (0, 0, None, False, False),  # nothing visible: exact zeros
    (150, 17, 4096, True, True),
]


def _table(rng, n_pages, max_pages, ps, kv_len, holes):
    """One lane's permuted table: pages up to kv_len allocated, the rest -1;
    with ``holes``, the second page and one near the middle of the visible
    range are holes too."""
    used = max(1, -(-kv_len // ps))
    row = np.full(max_pages, -1, np.int32)
    row[:used] = rng.permutation(n_pages)[:used]
    if holes:
        row[[min(1, used - 1), used // 2]] = -1
    return row


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
@pytest.mark.parametrize("group,ps", [(1, 8), (3, 16), (4, 64), (16, 128)])
def test_prefill_model_matches_pallas_and_plain(kind, group, ps):
    rng = np.random.default_rng(70 + group + ps)
    hkv, d = (2 if group < 16 else 1), 32
    max_pages = 320 // ps + 1
    n_pages = max_pages + 5
    (jk, tk), (jv, tv) = _pools(rng, kind, n_pages, ps, hkv, d)
    q = _bf16(rng.standard_normal((1, CHUNK, hkv * group, d)).astype(np.float32))
    slopes = (rng.standard_normal(hkv * group) * 0.1).astype(np.float32)
    rel_tol = ROW_REL_TOL if kind == "none" else KV_ROW_REL_TOL
    tiles = {}
    for chunk_pos, n_valid, window, holes, alibi in CASES:
        row = _table(rng, n_pages, max_pages, ps, chunk_pos + n_valid, holes)
        if holes:  # a hole inside the range the chunk's rows see
            assert (row[: -(-(chunk_pos + n_valid) // ps)] < 0).any()
        jkw = dict(sliding_window=window, alibi_slopes=jnp.asarray(slopes) if alibi else None)
        tkw = dict(sliding_window=window, alibi_slopes=torch.from_numpy(slopes) if alibi else None)
        pallas = np.array(jax_prefill(jnp.asarray(q), jk, jv, jnp.asarray(row), jnp.int32(chunk_pos),
                                        jnp.int32(n_valid), interpret=True, **jkw))[0, :n_valid]
        args = (torch.from_numpy(q), tk, tv, torch.from_numpy(row), chunk_pos, n_valid)
        plain = T.paged_prefill_attend(*args, **tkw)[0, :n_valid].float()
        for nwg in (1, 2):
            exact = wgmma_prefill_model(*args, nwg=nwg, exact=True, tiles=tiles, **tkw)[0, :n_valid]
            np.testing.assert_allclose(exact.numpy(), pallas, atol=EXACT_TOL, rtol=0)
            got = wgmma_prefill_model(*args, nwg=nwg, **tkw)[0]
            assert torch.isfinite(got).all()
            got = got[:n_valid]
            if n_valid:
                assert _row_limit_ratio(got, plain, rel_tol) <= 1, (chunk_pos, nwg)
                assert _row_limit_ratio(got, torch.from_numpy(pallas), rel_tol) <= 1, (chunk_pos, nwg)
            # a row that sees nothing (before the holes, or n_valid 0) is exact zeros
            blind = torch.from_numpy(pallas).abs().amax(dim=-1) == 0
            assert not got[blind].any() and not plain[blind].any()
    # both paths of the kernel ran: tiles every row sees whole, and edge tiles
    assert tiles.get("interior", 0) and tiles.get("edge", 0), tiles


def test_prefill_model_is_the_same_for_one_or_two_warpgroups():
    """The warpgroups of a block share its tiles; each row's arithmetic is
    its own, so the outputs are equal up to float32 order."""
    rng = np.random.default_rng(80)
    (_, tk), (_, tv) = _pools(rng, "nf4a", 12, 16, 2, 32)
    q = torch.from_numpy(_bf16(rng.standard_normal((1, 70, 8, 32)).astype(np.float32)))
    row = torch.from_numpy(_table(rng, 12, 10, 16, 150, holes=True))
    one = wgmma_prefill_model(q, tk, tv, row, 80, 70, sliding_window=30)
    two = wgmma_prefill_model(q, tk, tv, row, 80, 70, sliding_window=30, nwg=2)
    np.testing.assert_allclose(one.numpy(), two.numpy(), atol=EXACT_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["none", "int8", "nf4a"])
def test_plain_versions_mask_holes_as_the_pallas_kernels_skip_them(kind):
    """A hole inside the visible range is no position (the TPU kernels skip
    its page; a zero row would take a share of the softmax): the port's plain
    prefill and decode versions agree with the Pallas kernels there. Within
    EXACT_TOL on a floating-point pool; within KV_QUANT_TOL on a quantized
    one (the plain versions decode to bf16 values, the Pallas kernels to
    float32)."""
    rng = np.random.default_rng(81)
    ps, hkv, group, d, max_pages, n_pages = 8, 2, 2, 16, 8, 12
    tol = EXACT_TOL if kind == "none" else KV_QUANT_TOL
    (jk, tk), (jv, tv) = _pools(rng, kind, n_pages, ps, hkv, d)
    row = _table(rng, n_pages, max_pages, ps, 40, holes=True)
    q = _bf16(rng.standard_normal((1, 12, hkv * group, d)).astype(np.float32))
    want = np.asarray(jax_prefill(jnp.asarray(q), jk, jv, jnp.asarray(row), jnp.int32(28), jnp.int32(12),
                                  interpret=True))
    got = T.paged_prefill_attend(torch.from_numpy(q), tk, tv, torch.from_numpy(row), 28, 12)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    tables = np.stack([row, _table(rng, n_pages, max_pages, ps, 30, holes=True)])
    pos = np.array([39, 29], np.int32)
    qd = _bf16(rng.standard_normal((2, 1, hkv * group, d)).astype(np.float32))
    want = np.asarray(jax_decode(jnp.asarray(qd), jk, jv, jnp.asarray(tables), jnp.asarray(pos), interpret=True))
    got = T.paged_attend(torch.from_numpy(qd), tk, tv, torch.from_numpy(tables), torch.from_numpy(pos))
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
