"""The port's server-side sampling against petals_tpu's, on the CPU:

- ``ops/threefry.py``'s ``uniform_for_draw`` bit for bit equal to
  ``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(s), i))`` over
  a grid of seeds and draws and 200 random pairs, and the client's scalar
  form equal to petals_tpu's client's;
- ``sample_tokens`` (tokens equal) and ``warp_logits`` (the same -inf
  pattern, values within 1e-6) on [8, 256] and [8, 32000] float32 logits
  whose rows mix greedy, temperature, top-k (0, in range, past the
  vocabulary), top-p, the repetition penalty over seen masks, and planted
  ties;
- ``sampling_vectors`` the same dict, and ``validate_gen_sampling`` the
  same dict or the same error, as petals_tpu's;
- the client's ``sample_next_token`` with ``rng_key`` equal to
  petals_tpu's client's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client import remote_generation as jax_gen
from petals_tpu.ops import sampling as jax_sampling
from petals_tpu.rpc.protocol import validate_gen_sampling as jax_validate
from petals_tpu_torch.client import remote_generation as port_gen
from petals_tpu_torch.ops import sampling
from petals_tpu_torch.ops.threefry import uniform_for_draw
from petals_tpu_torch.rpc.protocol import validate_gen_sampling

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
DRAWS = (0, 1, 2, 31, 1000, 2**31 - 1)


def _jax_uniform(seed, draw):
    return np.float32(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(int(seed)), int(draw))))


def test_uniform_for_draw_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    pairs = [(s, i) for s in SEEDS for i in DRAWS]
    pairs += list(zip(rng.integers(0, 2**31, 200), rng.integers(0, 2**31, 200)))
    seeds, draws = (np.asarray(x, np.int64) for x in zip(*pairs))
    got = uniform_for_draw(seeds, draws)  # vectorised over every pair at once
    want = np.asarray([_jax_uniform(s, i) for s, i in pairs], np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ((got >= 0) & (got < 1)).all()
    # the scalar form, and the clients' floats
    assert uniform_for_draw(7, 3).view(np.uint32) == _jax_uniform(7, 3).view(np.uint32)
    assert port_gen.uniform_for_draw(12345, 31) == jax_gen.uniform_for_draw(12345, 31)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        uniform_for_draw(1 << 31, 0)


def _scene(vocab, seed):
    """[8, vocab] logits and per-row settings: rows 0 and 6 greedy (6 under
    a penalty), 1 plain sampling with ties at the maximum, 2 top-k 5 with a
    tied block, 3 top-p 0.9, 4 all four at once, 5 top-k past the vocabulary,
    7 top-k 1 with a tiny top-p."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((8, vocab)) * 3).astype(np.float32)
    logits[1, :10] = logits[1].max()  # ties at the top: the sort keeps index order
    logits[2, 5:9] = 4.0  # a tied block around the top-k threshold
    logits[3, [3, 40]] = logits[3].max() + 1.0  # two equal leaders under top-p
    vec = {
        "do_sample": np.array([0, 1, 1, 1, 1, 1, 0, 1], bool),
        "temperature": np.array([1, 0.7, 1, 1.3, 0.8, 1, 1, 0.5], np.float32),
        "top_k": np.array([0, 0, 5, 0, 50, vocab + 3, 0, 1], np.int32),
        "top_p": np.array([1, 1, 1, 0.9, 0.8, 1, 1, 0.3], np.float32),
        "repetition_penalty": np.array([1.2, 1, 1, 1, 1.3, 1, 1.5, 1], np.float32),
        "seen_mask": rng.random((8, vocab)) < 0.1,
        "seeds": rng.integers(0, 2**31, 8).astype(np.int32),
        "draw_idx": rng.integers(0, 1000, 8).astype(np.int32),
    }
    return logits, vec


@pytest.mark.parametrize("vocab", [256, 32000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_and_warp_equal_petals_tpu(vocab, seed):
    logits, vec = _scene(vocab, seed)
    want = np.asarray(jax_sampling.sample_tokens(jnp.asarray(logits), **{k: jnp.asarray(v) for k, v in vec.items()}))
    samp = sampling.sampling_tensors(vec)
    got = sampling.sample_tokens(torch.from_numpy(logits), **samp)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)

    penalized = np.asarray(jax_sampling.penalize_repetition(
        jnp.asarray(logits), jnp.asarray(vec["seen_mask"]), jnp.asarray(vec["repetition_penalty"])))
    got_pen = sampling.penalize_repetition(torch.from_numpy(logits), samp["seen_mask"], samp["repetition_penalty"])
    np.testing.assert_array_equal(got_pen.numpy(), penalized)
    want_warp = np.asarray(jax_sampling.warp_logits(
        jnp.asarray(penalized), jnp.asarray(vec["temperature"]), jnp.asarray(vec["top_k"]), jnp.asarray(vec["top_p"])))
    got_warp = sampling.warp_logits(got_pen, samp["temperature"], samp["top_k"], samp["top_p"]).numpy()
    np.testing.assert_array_equal(np.isneginf(got_warp), np.isneginf(want_warp))
    finite = np.isfinite(want_warp)
    np.testing.assert_allclose(got_warp[finite], want_warp[finite], atol=1e-6, rtol=0)
    # the cuts are real: top-k 5 keeps its 5 and the tied block, top-k past
    # the vocabulary keeps all, top-k 1 one token
    assert np.isfinite(got_warp[5]).all() and np.isfinite(got_warp[7]).sum() == 1
    assert np.isfinite(got_warp[2]).sum() >= 5


def test_sampling_vectors_equal_petals_tpu():
    context = [3, 3, 17, 250, 999, -1]
    cases = [None, {"do_sample": True, "temperature": 0.8, "top_k": 50, "top_p": 0.9, "repetition_penalty": 1.0,
                    "seed": 7, "offset": 5, "context": context},
             {"repetition_penalty": 1.3, "seed": 2, "offset": 9, "context": context}]
    for case in cases:
        for override in (None, 4):
            want = jax_sampling.sampling_vectors(3, 256, case, offset_override=override)
            got = sampling.sampling_vectors(3, 256, case, offset_override=override)
            assert sorted(got) == sorted(want)
            for name in want:
                assert got[name].dtype == want[name].dtype, name
                np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("payload", [
    None, {}, {"do_sample": 1, "temperature": 0.5, "top_k": None, "top_p": None, "seed": 3, "context": (1, 2)},
    {"repetition_penalty": 0, "offset": 4}, [1, 2], {"temperature": 0}, {"top_k": -1}, {"top_p": 0},
    {"top_p": 1.5}, {"repetition_penalty": -2}, {"seed": 1 << 31}, {"seed": -1}, {"offset": -3},
    {"context": 5}, {"temperature": "x"},
])
def test_validate_gen_sampling_equals_petals_tpu(payload):
    try:
        want = jax_validate(payload)
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as err:
            validate_gen_sampling(payload)
        assert str(err.value) == str(e)
        return
    assert validate_gen_sampling(payload) == want


def test_client_replay_draw_equals_petals_tpu():
    """``sample_next_token(rng_key=...)``: the inverse-CDF draw a client
    finishes a broken server-side stream with."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 300)) * 2).astype(np.float32)
    for key in ((7, 0), (7, 5), (123, 31)):
        for kwargs in ({}, {"top_k": 20}, {"top_p": 0.8, "temperature": 0.7}):
            want = jax_gen.sample_next_token(logits, do_sample=True, rng_key=key, **kwargs)
            got = port_gen.sample_next_token(logits, do_sample=True, rng_key=key, **kwargs)
            np.testing.assert_array_equal(got, want)
