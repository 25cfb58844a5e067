"""The port's dense flash attention (ops/flash_attention.py) on the CPU, where
the wrapper runs the kernel's plain version, against the JAX package on the
same numpy inputs: ``petals_tpu.ops.flash_attention.flash_attend`` in Pallas
interpret mode (as tests/test_ops_attention.py runs it; it takes buffer
lengths that are multiples of 128 only) and the XLA ``attend_reference``.

Tolerance, float32: atol 2e-5 (rtol 1e-5) against both, what
tests/test_ops_attention.py holds the TPU kernel to: the three versions sum in
different orders and divide at different places. bfloat16: 3e-2 as there.
Then the dispatch of ``attend``: chunks of 8 rows and more with scalar
positions reach the kernel's wrapper, decode shapes and per-lane positions
take ``attend_reference``, and on the CPU the wrapper IS the plain version,
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petals_tpu_torch.ops.attention as port_attention
from petals_tpu.ops.alibi import build_alibi_slopes
from petals_tpu.ops.attention import attend_reference as jax_reference
from petals_tpu.ops.flash_attention import flash_attend as jax_flash
from petals_tpu_torch.ops import flash_attention as fa
from petals_tpu_torch.ops.attention import attend, attend_reference

ATOL, RTOL = 2e-5, 1e-5


def _qkv(batch, q_len, buf, hq, hkv, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32)
                 for shape in ((batch, q_len, hq, d), (batch, buf, hkv, d), (batch, buf, hkv, d)))


def _port(q, k, v, dtype=torch.float32, **kw):
    slopes = kw.pop("alibi_slopes", None)
    if slopes is not None:
        kw["alibi_slopes"] = torch.from_numpy(np.asarray(slopes, np.float32))
    return fa.flash_attend(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **kw)


CASES = {
    # name: (batch, q_len, buf, hq, hkv, d, kwargs)
    "offset0_mha": (1, 128, 128, 4, 4, 64, {}),
    "gqa4_batch2": (2, 136, 256, 8, 2, 64, {"kv_length": 136}),
    "mqa8_ragged_q": (1, 100, 128, 8, 1, 128, {"kv_length": 100}),  # q_len not a multiple of 8
    "continuation": (1, 60, 256, 4, 4, 64, {"q_offset": 130, "kv_length": 190}),
    "kv_length_below_buffer": (2, 128, 384, 4, 2, 64, {"q_offset": 32, "kv_length": 160}),
    "window_32": (1, 200, 256, 4, 2, 64, {"kv_length": 200, "sliding_window": 32}),
    "window_100_continuation": (1, 90, 256, 4, 4, 64, {"q_offset": 128, "kv_length": 218, "sliding_window": 100}),
    "window_beyond_length": (1, 128, 128, 4, 2, 64, {"sliding_window": 1000}),
    "alibi_5_heads": (1, 128, 128, 5, 5, 64, {"alibi": True}),
    "alibi_gqa_window": (2, 70, 128, 8, 2, 64, {"kv_length": 70, "alibi": True, "sliding_window": 48}),
}


def _case(name):
    batch, q_len, buf, hq, hkv, d, kw = CASES[name]
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi_slopes"] = np.array(build_alibi_slopes(hq), np.float32)  # a writable copy
    return _qkv(batch, q_len, buf, hq, hkv, d, seed=sorted(CASES).index(name)), kw


def _jax_kwargs(kw):
    kw = dict(kw)
    if "alibi_slopes" in kw:
        kw["alibi_slopes"] = jnp.asarray(kw["alibi_slopes"])
    return kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_reference(name):
    (q, k, v), kw = _case(name)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **_jax_kwargs(kw))
    got = _port(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_interpret(name):
    (q, k, v), kw = _case(name)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **_jax_kwargs(kw))
    np.testing.assert_allclose(_port(q, k, v, **kw).numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_port_attend_reference(name):
    (q, k, v), kw = _case(name)
    tkw = dict(kw)
    if "alibi_slopes" in tkw:
        tkw["alibi_slopes"] = torch.from_numpy(tkw["alibi_slopes"])
    want = attend_reference(*(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    np.testing.assert_allclose(_port(q, k, v, **kw).numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("buf,q_len", [(100, 100), (77, 13), (200, 9)])
def test_any_buffer_length(buf, q_len):
    """The CUDA kernel masks the ragged edge itself, so the port takes buffer
    lengths the TPU kernel refuses (not multiples of 128): held to XLA."""
    q, k, v = _qkv(2, q_len, buf, 4, 2, 64, seed=20)
    kw = {"q_offset": buf - q_len - 3, "kv_length": buf - 3, "sliding_window": 40}
    assert fa.flash_supported(*(torch.from_numpy(x) for x in (q, k, v)), sliding_window=40)
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    np.testing.assert_allclose(_port(q, k, v, **kw).numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_bf16_matches_jax():
    q, k, v = _qkv(1, 128, 128, 4, 4, 64, seed=21)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    got = _port(q, k, v, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for want in (jax_reference(jq, jk, jv), jax_flash(jq, jk, jv, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("kw", [
    {"kv_length": 0},  # nothing is valid yet
    {"q_offset": 0, "kv_length": 64, "sliding_window": 1},  # every row sees itself only
])
def test_rows_that_see_nothing_give_exact_zeros(kw):
    q, k, v = _qkv(1, 16, 64, 4, 2, 64, seed=22)
    got = _port(q, k, v, **kw).numpy()
    assert np.isfinite(got).all()
    if kw["kv_length"] == 0:
        assert (got == 0).all()
    else:  # window 1: row i is exactly v[i] of its kv head
        np.testing.assert_allclose(got, np.repeat(v[:, :16], 2, axis=2), atol=1e-6)
    # rows past kv_length in a chunk that overruns it see only the valid prefix
    got = _port(q, k, v, q_offset=60, kv_length=64, sliding_window=4).numpy()
    assert np.isfinite(got).all()
    assert (got[:, 8:] == 0).all() and (got[:, :4] != 0).any()  # rows at 68.. see (64, 68] : nothing


def test_strided_views_are_read_in_place():
    """A session's per-block cache is a view of the span-stacked buffer."""
    rng = np.random.RandomState(23)
    stack = torch.from_numpy(rng.randn(3, 2, 2, 64, 2, 64).astype(np.float32))  # [kv, blocks, b, L, hkv, d]
    q = torch.from_numpy(rng.randn(2, 24, 4, 64).astype(np.float32))
    k_view, v_view = stack[0, 1], stack[1, 1]
    assert not stack[0][:, 0].is_contiguous()
    got = fa.flash_attend(q, k_view, v_view, kv_length=24)
    want = fa.flash_attend(q, k_view.clone(), v_view.clone(), kv_length=24)
    assert torch.equal(got, want)
    lane = stack[0][:, 1:2]  # a dense pool's lane [blocks, 1, L, hkv, d]: block 0 of it
    assert torch.equal(fa.flash_attend(q[:1], lane[0], lane[1], kv_length=24),
                       fa.flash_attend(q[:1], lane[0].clone(), lane[1].clone(), kv_length=24))


# ------------------------------------------------------------------ dispatch


@pytest.fixture
def spies(monkeypatch):
    calls = []
    real_flash, real_ref = fa.flash_attend, port_attention.attend_reference

    def flash(*a, **kw):
        calls.append("flash")
        return real_flash(*a, **kw)

    def ref(*a, **kw):
        calls.append("reference")
        return real_ref(*a, **kw)

    monkeypatch.setattr(fa, "flash_attend", flash)
    monkeypatch.setattr(port_attention, "attend_reference", ref)
    return calls


@pytest.mark.parametrize("q_len,use_flash,vector,want", [
    (8, True, False, "flash"),
    (64, True, False, "flash"),
    (7, True, False, "reference"),  # decode shapes: plain attention
    (1, True, False, "reference"),
    (64, False, False, "reference"),
    (64, True, True, "reference"),  # per-lane positions: plain attention
])
def test_attend_dispatch(spies, q_len, use_flash, vector, want):
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, q_len, 96, 4, 2, 64, seed=24))
    if vector:
        q_offset = torch.tensor([3, 9], dtype=torch.int32)
        kv_length = q_offset + q_len
    else:
        q_offset, kv_length = 5, 5 + q_len
    out = attend(q, k, v, q_offset=q_offset, kv_length=kv_length, sliding_window=50, use_flash=use_flash)
    assert spies == [want]
    ref = attend_reference(q, k, v, q_offset=q_offset, kv_length=kv_length, sliding_window=50)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)


def test_cpu_wrapper_is_the_plain_version_bit_for_bit():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 40, 96, 8, 2, 64, seed=25))
    kw = {"q_offset": 11, "kv_length": 51, "sliding_window": 30}
    before = fa.flash_attend.launches
    assert torch.equal(fa.flash_attend(q, k, v, **kw), fa.flash_attend_reference(q, k, v, **kw))
    assert torch.equal(attend(q, k, v, use_flash=True, **kw), fa.flash_attend_reference(q, k, v, **kw))
    assert fa.flash_attend.launches == before  # the counter counts kernel launches only


def test_flash_supported_rule():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 50, 4, 2, 64, seed=26))
    assert fa.flash_supported(q, k, v)  # any buffer length
    assert not fa.flash_supported(q[:, :7], k, v)
    assert not fa.flash_supported(q, k, v, sliding_window=0)
    fa.flash_attend.launches = 5
    fa.reset_launch_counts()
    assert fa.flash_attend.launches == 0
