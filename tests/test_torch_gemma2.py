"""The Gemma-2 family in the port against petals_tpu's, on the CPU, on
``make_tiny_gemma2`` (four folded norms, the query scale from
query_pre_attn_scalar, the attention and final logit softcaps, sliding
window 6 on even layers and full attention on odd ones, a tied head).

- Each package's own loader gives the same config and the same weights;
  each block's window is a host int (6 on block 0, 0 on block 1), read at
  load, as petals_tpu's int32 leaf says.
- A sliding and a full block each equal petals_tpu's ``block_apply`` in the
  five cache modes of tests/test_torch_bloom.py ``block_parity`` (its
  12-row chunk crosses the window of 6).
- The whole model (embedding, four blocks, final norm, softcapped head)
  gives petals_tpu's logits over a 12-token prefill and three cached decode
  steps past the window, on a dense cache and on paged pools (bf16, int8,
  nf4a): the twin of tests/test_new_families.py
  ``test_gemma2_block_exact_and_e2e``. Without the attention softcap the
  logits move, so the cap is held, not just passed.
- The client pieces, ``cast_exempt`` under bf16 loading and the
  quantization tables (fused wqkv / wgu) follow the JAX package's.
- A port server's greedy tokens equal a petals_tpu server's, over the
  window (dense weights and int8), and a mixed chain gives the all-port
  stream.

Tolerances: tests/test_torch_bloom.py's; the model's logits within 2e-4
(float32, as the JAX test holds them to HF), its bf16 pool runs within
2e-2 of the logits' largest magnitude."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.from_pretrained import load_client_params as jax_load_client
from petals_tpu.ops import paged_attention as J
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu_torch.client.from_pretrained import load_client_params
from petals_tpu_torch.ops import paged_attention as T
from petals_tpu_torch.server.from_pretrained import load_block_params
from petals_tpu_torch.utils.convert import block_params_from_numpy
from tests.test_torch_bloom import (
    MODES,
    _pools,
    block_parity,
    check,
    client_parity,
    greedy_streams,
    jax_apply,
    loaders_agree,
    quant_tables_parity,
    t,
)
from tests.utils import make_tiny_gemma2

pytestmark = pytest.mark.timeout(300)

LOGIT_ATOL = 2e-4


@pytest.fixture(scope="module")
def gemma2(tmp_path_factory):
    path = make_tiny_gemma2(str(tmp_path_factory.mktemp("models")))
    sliding, full = loaders_agree(path, block=0), loaders_agree(path, block=1)
    return path, sliding, full


def test_gemma2_windows_are_host_ints(gemma2):
    path, sliding, full = gemma2
    _, _, family, cfg, _ = sliding
    assert cfg.layer_types == ("sliding_attention", "full_attention") * 2 and cfg.sliding_window == 6
    assert cfg.attn_logit_softcapping == 50.0 and cfg.final_logit_softcapping == 30.0
    windows = [load_block_params(path, i, dtype=torch.float32, device="cpu")["attn_window"] for i in range(4)]
    assert windows == [6, 0, 6, 0] and all(type(w) is int for w in windows)
    assert int(sliding[-1]["attn_window"]) == 6 and int(full[-1]["attn_window"]) == 0
    # the carry from the JAX package's int32 leaf gives the same host int
    assert block_params_from_numpy(sliding[-1], "cpu", torch.float32)["attn_window"] == 6
    # an older config without layer_types: sliding on the even layers
    old = dataclasses.replace(cfg, layer_types=())
    assert family.config_from_hf(_namespace(old, layer_types=None)).layer_types == cfg.layer_types


def _namespace(cfg, **over):
    import types

    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(over)
    return types.SimpleNamespace(**fields)


@pytest.mark.parametrize("block", ["sliding", "full"])
@pytest.mark.parametrize("mode", MODES)
def test_gemma2_block_matches_petals_tpu(gemma2, block, mode):
    jfamily, jcfg, family, cfg, params = gemma2[1 if block == "sliding" else 2]
    block_parity(jfamily, jcfg, family, cfg, params, mode, seed=61)


KEEP = object()


def _model(path, kind, bf16=False, jax_cap=KEEP, port_cap=KEEP, q_gain=1.0):
    """(port logits, JAX logits) of the whole model over 12 prefill tokens
    and three decode steps, on a dense cache (``kind`` "dense") or on paged
    pools of ``kind`` (bf16, int8, nf4a) with permuted tables; ``jax_cap`` /
    ``port_cap`` replace either side's attention softcap, ``q_gain``
    multiplies every block's query projection on both sides."""
    from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
    from petals_tpu_torch.server.from_pretrained import get_block_config

    (jfamily, jcfg), (family, cfg) = jax_block_config(path), get_block_config(path)
    if jax_cap is not KEEP:
        jcfg = dataclasses.replace(jcfg, attn_logit_softcapping=jax_cap)
    if port_cap is not KEEP:
        cfg = dataclasses.replace(cfg, attn_logit_softcapping=port_cap)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jblocks = [jax_load_block(path, i, dtype=jdt) for i in range(4)]
    tblocks = [load_block_params(path, i, dtype=tdt, device="cpu") for i in range(4)]
    for jb, tb in zip(jblocks, tblocks):
        jb["wq"], tb["wq"] = jb["wq"] * q_gain, tb["wq"] * q_gain
    jc = jax_load_client(path, dtype=jnp.float32, family=jfamily, cfg=jcfg)
    tc = load_client_params(path, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
    ids = np.random.default_rng(0).integers(0, 100, (1, 15))
    hkv, d = cfg.num_key_value_heads, cfg.head_dim
    if kind == "dense":
        jkvs = [(jnp.zeros((1, 32, hkv, d), jdt),) * 2 for _ in range(4)]
        tkvs = [(torch.zeros(1, 32, hkv, d, dtype=tdt), torch.zeros(1, 32, hkv, d, dtype=tdt)) for _ in range(4)]
        table = None
    else:
        rng = np.random.default_rng(7)
        pools = [_pools(rng, kind, 12, 4, hkv, d, bf16) for _ in range(4)]
        table = rng.permutation(12)[:8].astype(np.int32)[None]
    jouts, touts = [], []
    for pos, n in ((0, 12), (12, 1), (13, 1), (14, 1)):
        jh = jfamily.client_embed(jc, jnp.asarray(ids[:, pos : pos + n]), jcfg).astype(jdt)
        th = family.client_embed(tc, ids[:, pos : pos + n], cfg).to(tdt)
        for i in range(4):
            if table is None:
                jh, jkvs[i] = jax_apply(jfamily, jblocks[i], jh, jkvs[i], pos, jcfg)
                th, tkvs[i] = family.block_apply(tblocks[i], th, tkvs[i], pos, cfg)
                continue
            (jk, tk), (jv, tv) = pools[i]
            jkv = (J.PagedKV(jk, jnp.asarray(table)), J.PagedKV(jv, jnp.asarray(table)))
            tkv = (T.PagedKV(tk, t(table)), T.PagedKV(tv, t(table)))
            if n == 1:  # decode: a [lanes] position vector
                jh, (jk2, jv2) = jax_apply(jfamily, jblocks[i], jh, jkv, jnp.asarray([pos], jnp.int32), jcfg)
                th, _ = family.block_apply(tblocks[i], th, tkv, torch.tensor([pos], dtype=torch.int32), cfg)
            else:
                jh, (jk2, jv2) = jax_apply(jfamily, jblocks[i], jh, jkv, pos, jcfg, n_valid=n)
                th, _ = family.block_apply(tblocks[i], th, tkv, pos, cfg, n_valid=n)
            pools[i] = ((jk2.pool, tk), (jv2.pool, tv))
        jouts.append(np.asarray(jfamily.client_head(jc, jh.astype(jnp.float32), jcfg)))
        touts.append(family.client_head(tc, th.float(), cfg).numpy())
    return np.concatenate(touts, axis=1), np.concatenate(jouts, axis=1)


@pytest.mark.parametrize("kind", ["dense", "bf16", "int8", "nf4a"])
def test_gemma2_model_logits_match_petals_tpu(gemma2, kind):
    """Prefill across the window, then decode on both layer types, with both
    softcaps (the final one bounds every logit by 30)."""
    got, want = _model(gemma2[0], kind, bf16=kind == "bf16")
    assert np.abs(want).max() <= 30.0
    if kind == "bf16":
        check(got, want, True, "gemma2 logits on bf16 pools")
    else:
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0, err_msg=f"gemma2 logits ({kind})")


def test_gemma2_attention_softcap_is_held(gemma2):
    """The tiny model's scores are far below the published cap of 50, so
    the cap barely bends them there: here the queries are scaled by 30 (the
    scores reach a few units) and the cap is 1, which bends every score.
    The port's logits follow petals_tpu's, and leaving the cap out moves
    them far."""
    got, want = _model(gemma2[0], "dense", jax_cap=1.0, port_cap=1.0, q_gain=30.0)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    uncapped, _ = _model(gemma2[0], "dense", jax_cap=1.0, port_cap=None, q_gain=30.0)
    assert np.abs(uncapped - want).max() > 100 * LOGIT_ATOL


def test_gemma2_attend_reference_softcap_matches_jax():
    """``attend_reference`` with the softcap against petals_tpu's, with ALiBi
    and a window, scalar and per-lane positions."""
    from petals_tpu.ops.attention import attend_reference as jax_attend
    from petals_tpu_torch.ops.attention import attend_reference

    rng = np.random.default_rng(62)
    q = (rng.standard_normal((2, 5, 4, 16)) * 3).astype(np.float32)
    k, v = rng.standard_normal((2, 2, 12, 2, 16)).astype(np.float32)
    slopes = (rng.standard_normal(4) * 0.1).astype(np.float32)
    for q_offset, kv_length, window in ((7, 12, None), (np.array([3, 6], np.int32), np.array([8, 11], np.int32), 4)):
        kw = dict(logit_softcap=2.5, sliding_window=window)
        want = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=jnp.asarray(q_offset),
                          kv_length=jnp.asarray(kv_length), alibi_slopes=jnp.asarray(slopes), **kw)
        got = attend_reference(t(q), t(k), t(v), q_offset=torch.as_tensor(q_offset), kv_length=torch.as_tensor(kv_length),
                               alibi_slopes=t(slopes), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gemma2_norm_folds_survive_bf16_loading(gemma2):
    params = load_block_params(gemma2[0], 0, dtype=torch.bfloat16, device="cpu")
    for name in ("ln1", "ln1_post", "ln2_pre", "ln2_post"):
        assert params[name].dtype == torch.float32, name
    assert params["wq"].dtype == torch.bfloat16 and params["attn_window"] == 6
    client = load_client_params(gemma2[0], dtype=torch.bfloat16, device="cpu")
    assert client["norm"].dtype == torch.float32 and client["embed"].dtype == torch.bfloat16


def test_gemma2_client_pieces_match_jax(gemma2):
    client_parity(gemma2[0], [3, 17, 42, 5])


def test_gemma2_quantization_tables_match_jax(gemma2):
    quant_tables_parity(gemma2[1][-1], "gemma2")


@pytest.mark.parametrize("quant_type", ["none", "int8"])
def test_gemma2_greedy_tokens_match_petals_tpu_server(gemma2, quant_type):
    port, jax_tokens = greedy_streams(gemma2[0], 4, quant_type, [3, 17, 42, 5, 99])
    assert port == jax_tokens


def test_gemma2_mixed_chain_matches_port_server(gemma2):
    port, mixed = greedy_streams(gemma2[0], 4, "none", [7, 8, 9, 10], chain=True)
    assert port == mixed


def test_gemma2_throughput_probe_block_keeps_a_host_window(gemma2):
    """The throughput probe's random block (server/throughput.py) gives the
    window leaf a host int (0: full attention), as the loader does: a
    tensor there would be read on the host inside the probe's captured
    steps, which a CUDA graph refuses."""
    from petals_tpu_torch.server.throughput import _random_block

    _, _, family, cfg, _ = gemma2[1]
    block = _random_block(family, cfg, torch.device("cpu"), torch.bfloat16, "none")
    assert block["attn_window"] == 0 and type(block["attn_window"]) is int
    assert block["ln1"].dtype == torch.float32 and block["wq"].dtype == torch.bfloat16
