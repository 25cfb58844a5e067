"""The Phi-3 family in the port against petals_tpu's, on the CPU, on
``make_tiny_phi3`` (fused qkv_proj / gate_up_proj split at load; LongRoPE
with an original window of 64 positions of a maximum of 256, so tests past
position 64 take the long factors and the attention scale).

- Each package's own loader gives the same config (the factor lists, the
  original window and ``factor`` folded into the hashable rope_scaling
  tuple) and the same split weights.
- The block equals petals_tpu's ``block_apply`` in the five cache modes of
  tests/test_torch_bloom.py ``block_parity``.
- ``rotary_tables`` picks the factors per row from the real length as
  petals_tpu's does: a deep lane does not flip a shallow one, a padded tail
  does not trip the switch (``n_valid``), a known final length decides
  (``n_total``), with host ints and 0-dim tensors alike (the twin of
  tests/test_new_families.py ``test_longrope_per_row_and_padding_selection``).
- Cached decode across the original window's end (positions 62 to 65 after
  a 62-row prefill), a padded prefill chunk whose real end crosses it, and
  chunks of a prompt whose known final length crosses it equal petals_tpu's
  block on dense caches and on paged pools (the twin of
  ``test_phi3_longrope_boundary_crossing``).
- A port server's greedy tokens equal a petals_tpu server's over a prompt
  whose prefill crosses the window in chunks of the server's budget, and a
  mixed chain gives the all-port stream.

Tolerances: tests/test_torch_bloom.py's (float32 atol 1e-4); rotary tables
within 1e-6 (the same float32 formula)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.ops import paged_attention as J
from petals_tpu.ops.rotary import rotary_tables as jax_rotary_tables
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.ops.rotary import rotary_tables
from tests.test_torch_bloom import (
    ATOL,
    MODES,
    _pools,
    block_parity,
    both_params,
    check,
    greedy_streams,
    jax_apply,
    loaders_agree,
    quant_tables_parity,
    t,
)
from tests.utils import make_tiny_phi3

pytestmark = pytest.mark.timeout(300)

SCALING = {
    "rope_type": "longrope", "short_factor": (1.0, 1.0, 1.0, 1.0), "long_factor": (4.0, 4.0, 4.0, 4.0),
    "original_max_position_embeddings": 64, "factor": 4.0,
}


@pytest.fixture(scope="module")
def phi3(tmp_path_factory):
    path = make_tiny_phi3(str(tmp_path_factory.mktemp("models")), n_layers=2)
    return (path, *loaders_agree(path))


def test_phi3_config_folds_the_longrope_fields(phi3):
    cfg = phi3[4]
    scaling = dict(cfg.rope_scaling)
    assert scaling["original_max_position_embeddings"] == 64 and scaling["factor"] == 4.0
    assert len(scaling["long_factor"]) == cfg.head_dim // 2 and cfg.sliding_window is None
    hash(cfg)  # hashable, as a static block config must be


@pytest.mark.parametrize("mode", MODES)
def test_phi3_block_matches_petals_tpu(phi3, mode):
    _, jfamily, jcfg, family, cfg, params = phi3
    block_parity(jfamily, jcfg, family, cfg, params, mode, seed=81)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_longrope_per_row_and_padding_selection(as_tensor):
    def both(positions, **kw):
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.tensor(v) if as_tensor else v for k, v in kw.items()}
        want = jax_rotary_tables(jnp.asarray(positions, jnp.int32), 8, rope_scaling=dict(SCALING), **jkw)
        got = rotary_tables(torch.tensor(positions, dtype=torch.int32), 8, rope_scaling=dict(SCALING), **tkw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
        return got[0]

    # batched decode: a shallow lane (5), a deep one (100), the idle sentinel
    mixed = both([[5], [100], [256]])
    assert (mixed[0] - both([[5]])[0]).abs().max() == 0 and (mixed[1] - both([[100]])[0]).abs().max() == 0
    # a padded chunk at 58: 8 real rows end at 66 (long), 2 at 60 (short),
    # whatever the padded tail's positions say
    padded = [list(range(58, 74))]
    long_rows, short_rows = both(padded, n_valid=8), both(padded, n_valid=2)
    assert (long_rows - short_rows).abs().max() > 1e-3
    assert (short_rows[0, :2] - both([[58, 59]])[0]).abs().max() == 0
    # a known final length overrides both: a first chunk of a 70-token prompt
    assert (both([list(range(16))], n_valid=16, n_total=70) - both([list(range(16))], n_valid=16)).abs().max() > 1e-3


def _dense_kv(hkv, d, length=128):
    return (jnp.zeros((1, length, hkv, d)),) * 2, (torch.zeros(1, length, hkv, d), torch.zeros(1, length, hkv, d))


def test_phi3_longrope_boundary_crossing(phi3):
    """A 62-row prefill, then decode steps at 62..65 (sequence 63..66 crosses
    the original window of 64): the cached rows keep their short-factor
    rotation on both sides, as in petals_tpu and HF's cache path."""
    _, jfamily, jcfg, family, cfg, params = phi3
    jp, tp = both_params(params, False)
    rng = np.random.default_rng(82)
    prefill = (rng.standard_normal((1, 62, cfg.hidden_size)) * 0.3).astype(np.float32)
    steps = (rng.standard_normal((4, 1, 1, cfg.hidden_size)) * 0.3).astype(np.float32)
    jkv, tkv = _dense_kv(cfg.num_key_value_heads, cfg.head_dim)
    jout, jkv = jax_apply(jfamily, jp, jnp.asarray(prefill), jkv, 0, jcfg)
    tout, tkv = family.block_apply(tp, t(prefill), tkv, 0, cfg)
    check(tout, jout, False, "phi3 prefill")
    for i, s in enumerate(steps):
        jout, jkv = jax_apply(jfamily, jp, jnp.asarray(s), jkv, 62 + i, jcfg)
        tout, tkv = family.block_apply(tp, t(s), tkv, 62 + i, cfg)
        check(tout, jout, False, f"phi3 decode at {62 + i}")
    for got, want in zip(tkv, jkv):
        check(got, want, False, "phi3 cache")


@pytest.mark.parametrize("pool", ["dense", "bf16", "int8", "nf4a"])
def test_phi3_longrope_padded_and_known_total(phi3, pool):
    """A chunk of 8 real rows at 58 padded to 16 (real end 66: long
    factors), then a 16-row first chunk of a prompt whose known final
    length is 70 (``n_total``: long from the first chunk on), against
    petals_tpu's block, on a dense cache and on paged pools."""
    _, jfamily, jcfg, family, cfg, params = phi3
    bf16 = pool == "bf16"
    jp, tp = both_params(params, bf16)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    hkv, d = cfg.num_key_value_heads, cfg.head_dim
    rng = np.random.default_rng(83)
    x = (rng.standard_normal((1, 16, cfg.hidden_size)) * 0.3).astype(np.float32)
    for position, n_valid, n_total in ((58, 8, None), (0, 16, 70)):
        extra = {} if n_total is None else {"n_total": n_total}
        if pool == "dense":
            jkv, tkv = _dense_kv(hkv, d)
        else:
            (jk, tk), (jv, tv) = _pools(rng, pool, 40, 4, hkv, d, bf16)
            table = rng.permutation(40)[:32].astype(np.int32)[None]
            jkv = (J.PagedKV(jk, jnp.asarray(table)), J.PagedKV(jv, jnp.asarray(table)))
            tkv = (T.PagedKV(tk, t(table)), T.PagedKV(tv, t(table)))
        jout, _ = jax_apply(jfamily, jp, jnp.asarray(x, jdt), jkv, position, jcfg, n_valid=n_valid, **extra)
        tout, _ = family.block_apply(tp, t(x).to(tdt), tkv, position, cfg, n_valid=n_valid, **extra)
        check(tout[:, :n_valid].float(), jout[:, :n_valid], bf16, f"phi3 chunk at {position} ({pool})")
        if n_total is not None and pool == "dense":  # the known total moved the rows past the tolerance
            short, _ = family.block_apply(tp, t(x), _dense_kv(hkv, d)[1], position, cfg, n_valid=n_valid)
            assert (short - tout).abs().max().item() > 4 * ATOL


def test_phi3_quantization_tables_match_jax(phi3):
    quant_tables_parity(phi3[-1], "phi3")


def _prefill_replies(path, n_layers, prompt):
    """The hidden states a port server and a petals_tpu server reply to one
    prefill of ``prompt`` (the port's client embeddings), each a server of
    every block (tests/test_torch_bloom.py's servers: the port's prefill
    budget 16 tokens, so a long prompt rides several mixed steps)."""
    import asyncio

    from petals_tpu_torch.client.from_pretrained import load_client_params
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array
    from petals_tpu_torch.server.from_pretrained import get_block_config
    from petals_tpu_torch.server.server import default_dht_prefix
    from tests.test_torch_bloom import _jax_server, _port_server

    family, cfg = get_block_config(path)
    client_params = load_client_params(path, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    hidden = family.client_embed(client_params, np.asarray([prompt]), cfg)
    uids = CHAIN_DELIMITER.join(make_uid(default_dht_prefix(path), i) for i in range(n_layers))

    async def one(server):
        await server.start()
        host = getattr(server, "host", None) or server.rpc_server.host
        client = await RpcClient.connect(host, server.rpc_server.port)
        try:
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": len(prompt) + 1, "batch_size": 1})
            await stream.recv(timeout=60)
            await stream.send({"tensors": {"hidden": serialize_array(hidden)}})
            out = deserialize_array((await stream.recv(timeout=60))["tensors"]["hidden"]).float()
            await stream.end()
            return out
        finally:
            await client.close()
            await server.shutdown()

    async def main():
        return (await one(_port_server(path, 0, n_layers, "none")),
                await one(_jax_server(path, 0, n_layers, "none")))

    return asyncio.run(main())


def test_phi3_chunked_prefill_takes_the_prompts_length(phi3):
    """A 70-token prompt through a port server's 16-token mixed-step chunks
    replies petals_tpu's hidden states (atol 1e-4): every chunk takes the
    long factors from the prompt's known length (the batcher's ``n_total``),
    as petals_tpu's server does, though the first chunks end inside the
    original window of 64 (chunk by chunk alone they would take the short
    factors, which moves these replies past the tolerance: the block-level
    twin above shows it)."""
    prompt = [int(i) for i in np.random.default_rng(85).integers(1, 120, 70)]
    port, jax_reply = _prefill_replies(phi3[0], 2, prompt)
    assert port.shape == (1, 70, 64)
    check(port, jax_reply, False, "phi3 chunked prefill")


def test_phi3_greedy_tokens_match_petals_tpu_server(phi3):
    """A 70-token prompt prefilled in the servers' 16-token chunks: the
    later chunks cross the original window; every chunk takes the long
    factors from the prompt's final length, in both packages."""
    prompt = list(np.random.default_rng(84).integers(1, 120, 70))
    port, jax_tokens = greedy_streams(phi3[0], 2, "none", [int(i) for i in prompt], n_new=6)
    assert port == jax_tokens


def test_phi3_mixed_chain_matches_port_server(phi3):
    port, mixed = greedy_streams(phi3[0], 2, "none", [7, 8, 9, 10], chain=True)
    assert port == mixed
