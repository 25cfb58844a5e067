"""The port's integrity plane against petals_tpu's, on the CPU in float32.

- ``ops/fingerprint.py``'s numpy functions equal petals_tpu's bit for bit.
- ``ptu.probe`` of a port server answers a petals_tpu server's keys, seed,
  token clamp and span, its digest within 1e-5 relative.
- The fused digest of each batched step (paged decode, the dense pool's
  decode, mixed, generation, verify) equals petals_tpu's on the same
  inputs within 1e-5 relative and the client twin of the step's output
  within ``TOL_TRANSPORT``, and the decode-shaped paths agree with each
  other (tests/test_integrity.py:155's invariance). ``with_fp`` is part of
  the program key: a flip after a capture captures once more, and a flip
  back replays the first graph.
- A petals_tpu client with fingerprints on records no divergence against a
  port server that fuses them.
- The gate: a ``CanaryProber`` (the port's ``HealthMonitor.canary_probe``)
  and petals_tpu's ``HealthMonitor.canary_probe`` over two petals_tpu
  replicas and one port replica of a span quarantine nobody; a port replica
  served from a perturbed copy of the weights is named the outlier.

Every wait is bounded."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxModel
from petals_tpu.dht import DHTNode as JaxDHTNode
from petals_tpu.ops import fingerprint as J
from petals_tpu.server.server import Server as JaxServer
from petals_tpu.telemetry.integrity import get_quarantine as jax_quarantine
from petals_tpu.utils.health import HealthMonitor as JaxHealthMonitor
from petals_tpu_torch.ops import fingerprint as T
from petals_tpu_torch.server.server import Server, default_dht_prefix
from petals_tpu_torch.telemetry.integrity import get_quarantine as port_quarantine
from petals_tpu_torch.telemetry.observatory import Observatory, TrackedGraph
from petals_tpu_torch.utils.health import HealthMonitor
from tests.test_torch_dense_programs import OnceCapture
from tests.test_torch_forward import Pair
from tests.test_torch_spec_decode import PS, S, _backends, _jax_copy, _prefilled_pools, _vecs
from tests.test_torch_step_programs import _clone_pools
from tests.test_torch_swarm import Loop
from tests.utils import make_tiny_llama

N_LAYERS = 4
REL = 1e-5

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture
def fingerprints_on():
    prev = (J.enabled(), T.enabled())
    J.set_enabled(True)
    T.set_enabled(True)
    yield
    J.set_enabled(prev[0])
    T.set_enabled(prev[1])


# ------------------------------------------------------------------ numpy units


def _digests():
    rng = np.random.RandomState(0)
    return [rng.standard_normal(T.FP_DIM).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("name", ["projection", "fingerprint_output", "fp_close", "digest_hex", "fp_list",
                                  "tolerance_for"])
def test_numpy_functions_equal_petals_tpu(name):
    a, b, c = _digests()
    hidden = np.random.RandomState(1).standard_normal((1, 5, 96)).astype(np.float32)
    if name == "projection":
        for hsz, seed in ((64, None), (96, 7), (4096, 0x5EED)):
            got, want = T.projection(hsz, seed), J.projection(hsz, seed)
            assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    elif name == "fingerprint_output":
        for seed in (None, 3):
            assert T.fingerprint_output(hidden, 96, seed).tobytes() == J.fingerprint_output(hidden, 96, seed).tobytes()
    elif name == "fp_close":
        for x, y, rtol in ((a, a * (1 + 1e-4), 1e-3), (a, b, 1e-3), (a, c, 10.0), (a, a[:4], 1.0)):
            assert T.fp_close(x, y, rtol) == J.fp_close(x, y, rtol)
    elif name == "digest_hex":
        assert [T.digest_hex(x) for x in (a, b, c)] == [J.digest_hex(x) for x in (a, b, c)]
    elif name == "fp_list":
        assert [T.fp_list(x) for x in (a, b)] == [J.fp_list(x) for x in (a, b)]
    else:
        for q in (None, "none", "int8", "nf4", "NF4", "nf4a", "weird"):
            for kv in (None, "none", "int8", "nf4a", "other"):
                assert T.tolerance_for(q, kv) == J.tolerance_for(q, kv)
        assert (T.TOL_EXACT, T.TOL_TRANSPORT, T.TOL_LOSSY_WIRE, T.FP_DIM, T.DEFAULT_FP_SEED) == (
            J.TOL_EXACT, J.TOL_TRANSPORT, J.TOL_LOSSY_WIRE, J.FP_DIM, J.DEFAULT_FP_SEED)


def test_device_twin_is_a_float32_product():
    rows = torch.from_numpy(np.random.RandomState(2).standard_normal((3, 96)).astype(np.float32))
    proj = T.device_projection(96, "cpu")
    assert proj.dtype == torch.float32 and T.device_projection(96, "cpu") is proj  # uploaded once
    got = T.fingerprint_rows_torch(rows.to(torch.bfloat16), proj)
    want = T.fingerprint_rows(rows.to(torch.bfloat16).float().numpy(), T.projection(96))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ the probe


@pytest.fixture(scope="module")
def pair(model_path):
    p = Pair(model_path)
    yield p
    p.close()


@pytest.mark.parametrize("seed,tokens", [(None, None), (12345, 0), (2**40 + 9, 40), (7, 9)])
def test_rpc_probe_matches_petals_tpu(pair, seed, tokens):
    payload = {k: v for k, v in (("seed", seed), ("tokens", tokens)) if v is not None}
    client = {"port": pair.port_client, "jax": pair.jax_client}
    got, want = (pair.loop.run(client[w].call("ptu.probe", payload, timeout=60)) for w in ("port", "jax"))
    assert set(got) == set(want) == {"fp", "seed", "tokens", "fp_seed", "first_block", "n_blocks"}
    assert {k: got[k] for k in got if k != "fp"} == {k: want[k] for k in want if k != "fp"}
    assert got["tokens"] == (4 if tokens is None else max(1, min(tokens, 16)))
    assert len(got["fp"]) == T.FP_DIM
    assert T.fp_close(got["fp"], want["fp"], rtol=REL), (got["fp"], want["fp"])


# ------------------------------------------------------------------ fused digests

LANES = 3


def _scene(model_path, rows):
    jb, pb, jparams, params = _backends(model_path)
    rng = np.random.default_rng(21)
    positions = np.array([4, 9, PS * 4], np.int32)  # the last lane idles at the sentinel
    tables, jpools, tpools = _prefilled_pools(jb, pb.cfg, positions, 4, 17, rows, rng)
    hidden = (rng.standard_normal((LANES, 1, pb.hidden_size)) * 0.1).astype(np.float32)
    return jb, pb, jparams, params, positions, tables, jpools, tpools, hidden


def _dense_pools(tables, pools):
    """The paged pools' lanes as a dense lane pool [blocks, lanes, maxlen, hkv, d]."""
    out = []
    for pool in pools:
        pool = np.asarray(pool)
        dense = np.zeros((pool.shape[0], tables.shape[0], tables.shape[1] * PS, *pool.shape[3:]), np.float32)
        for lane in range(tables.shape[0]):
            for s, page in enumerate(tables[lane]):
                if page >= 0:
                    dense[:, lane, s * PS : (s + 1) * PS] = pool[:, page]
        out.append(dense)
    return out


def _twin_close(out, fp, lanes, hsz):
    out = np.asarray(out, np.float32)
    for lane in lanes:
        twin = T.fingerprint_output(out[lane : lane + 1], hsz)
        assert T.fp_close(twin, np.asarray(fp)[lane], rtol=T.TOL_TRANSPORT), lane


def _close_rows(got, want, lanes):
    for lane in lanes:
        assert T.fp_close(np.asarray(got)[lane], np.asarray(want)[lane], rtol=REL), lane


@pytest.mark.parametrize("path", ["paged", "dense", "mixed", "gen", "verify"])
def test_fused_digest_equals_petals_tpu_on_every_path(model_path, fingerprints_on, path):
    jb, pb, jparams, params, positions, tables, jpools, tpools, hidden = _scene(model_path, 8)
    hsz = pb.hidden_size
    live = (0, 1)
    # the reference for the decode-shaped paths: the port's paged decode step
    out_ref, _ = pb.paged_decode_step(torch.from_numpy(hidden), _clone_pools(tpools), positions, tables)
    fp_ref, chunk = pb.pop_step_fp()
    assert fp_ref is not None and chunk is None and tuple(fp_ref.shape) == (LANES, T.FP_DIM)
    assert pb.pop_step_fp() == (None, None)  # a stash is taken once
    if path == "paged":
        jb.paged_decode_step(hidden, _jax_copy(jpools), positions, tables)
        _close_rows(fp_ref, jb.pop_step_fp()[0], live)
        _twin_close(out_ref, fp_ref, live, hsz)
    elif path == "dense":
        dense = _dense_pools(tables, tpools)
        dense_pos = np.where(positions >= PS * 4, PS * 4, positions).astype(np.int32)
        out, _ = pb.batched_decode_step(torch.from_numpy(hidden), tuple(torch.from_numpy(d) for d in dense), dense_pos)
        fp, _ = pb.pop_step_fp()
        jb.batched_decode_step(hidden, tuple(jnp.asarray(d) for d in dense), dense_pos)
        _close_rows(fp, jb.pop_step_fp()[0], live)
        _twin_close(out, fp, live, hsz)
        for lane in live:  # the same lanes digest alike on both layouts
            assert T.fp_close(fp[lane], fp_ref[lane], rtol=T.TOL_TRANSPORT)
    elif path == "mixed":
        chunk = (np.random.default_rng(5).standard_normal((1, 6, hsz)) * 0.1).astype(np.float32)
        mixed_pos = positions.copy()
        mixed_pos[1] = PS * 4  # lane 1 prefills: its decode row idles
        dec, chunk_out, _ = pb.paged_mixed_step(torch.from_numpy(hidden), _clone_pools(tpools), mixed_pos, tables,
                                                torch.from_numpy(chunk), 1, int(positions[1]))
        fp, chunk_fp = pb.pop_step_fp()
        jb.paged_mixed_step(hidden, _jax_copy(jpools), mixed_pos, tables, chunk, 1, int(positions[1]))
        jfp, jchunk = jb.pop_step_fp()
        _close_rows(fp, jfp, (0,))
        assert T.fp_close(chunk_fp.numpy(), np.asarray(jchunk), rtol=REL)
        assert T.fp_close(fp[0], fp_ref[0], rtol=T.TOL_TRANSPORT)
        assert T.fp_close(T.fingerprint_output(chunk_out.numpy(), hsz), chunk_fp.numpy(), rtol=T.TOL_TRANSPORT)
    elif path == "gen":
        use = np.array([False, True, False])
        toks = np.array([0, 11, 0], np.int64)
        vec = _vecs(LANES, pb.cfg.vocab_size, False, 1)
        out, _, _ = pb.paged_gen_decode_step(params, torch.from_numpy(hidden), toks, use, _clone_pools(tpools),
                                             positions, tables, sampling_vecs=vec)
        fp, _ = pb.pop_step_fp()
        jb.paged_gen_decode_step(jparams, hidden, toks, use, _jax_copy(jpools), positions, tables,
                                 sampling_vecs=vec)
        _close_rows(fp, jb.pop_step_fp()[0], live)
        _twin_close(out, fp, live, hsz)
        assert T.fp_close(fp[0], fp_ref[0], rtol=T.TOL_TRANSPORT)  # lane 0 decodes its hidden either way
    else:
        tokens = np.array([[7, 1, 2, 3], [11, 4, 5, 6], [0, 0, 0, 0]], np.int32)
        assert tokens.shape[1] == S
        vec = _vecs(LANES, pb.cfg.vocab_size, False, 1)
        _, n_emit, _ = pb.paged_spec_verify_step(params, tokens, _clone_pools(tpools), positions, tables,
                                                 sampling_vecs=vec)
        fp, _ = pb.pop_step_fp()
        jb.paged_spec_verify_step(jparams, tokens, _jax_copy(jpools), positions, tables, sampling_vecs=vec)
        _close_rows(fp, jb.pop_step_fp()[0], live)
        # at one row a lane (k = 0) the verify step is the generation step
        g1 = tokens[:, :1]
        pb.paged_spec_verify_step(params, g1, _clone_pools(tpools), positions, tables, sampling_vecs=vec)
        fp1, _ = pb.pop_step_fp()
        pb.paged_gen_decode_step(params, torch.from_numpy(hidden), g1[:, 0].astype(np.int64),
                                 np.ones(LANES, bool), _clone_pools(tpools), positions, tables, sampling_vecs=vec)
        _close_rows(fp1, pb.pop_step_fp()[0], live)


def test_with_fp_is_part_of_the_program_key(model_path):
    """Through a stand-in capture: a flip after the capture captures once
    more (the digest is never read off a graph built without it), and a
    flip back replays the first graph."""
    _, pb, _, _, positions, tables, _, tpools, hidden = _scene(model_path, 8)
    stub = pb.__class__.__new__(pb.__class__)
    stub.__dict__.update(pb.__dict__)
    stub._decode_program = TrackedGraph("paged_decode", OnceCapture(), observatory=Observatory())
    pools = _clone_pools(tpools)
    prev = T.enabled()
    try:
        T.set_enabled(False)
        stub.paged_decode_step(torch.from_numpy(hidden), pools, positions, tables)
        assert stub.pop_step_fp() == (None, None)
        T.set_enabled(True)
        stub.paged_decode_step(torch.from_numpy(hidden), pools, positions, tables)
        assert stub.pop_step_fp()[0] is not None
        assert stub._decode_program.counts.captures == 2
        T.set_enabled(False)
        stub.paged_decode_step(torch.from_numpy(hidden), pools, positions, tables)
        assert stub.pop_step_fp() == (None, None)
        assert stub._decode_program.counts.captures == 2 and stub._decode_program.counts.replays == 3
    finally:
        T.set_enabled(prev)


# ------------------------------------------------------------------ a JAX client


def test_jax_client_records_no_divergence_against_a_port_server(model_path, fingerprints_on, tmp_path):
    loop = Loop()

    async def boot():
        boot_node = await JaxDHTNode.create(maintenance_period=1000)
        server = Server(model_path, first_block=0, num_blocks=N_LAYERS, initial_peers=[boot_node.own_addr.to_string()],
                        device="cpu", compute_dtype=torch.float32, throughput=1.0)
        await server.start()
        return boot_node, server

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path))
        boot_node, server = loop.run(boot())
    model = JaxModel.from_pretrained(model_path, initial_peers=[boot_node.own_addr.to_string()])
    try:
        rng = np.random.RandomState(4)
        with model.remote.inference_session(max_length=32) as sess:
            for n in (6, 1, 1, 1):
                sess.step((rng.standard_normal((1, n, server.cfg.hidden_size)) * 0.1).astype(np.float32))
            monitor = sess._session.integrity
            assert monitor.checked == 4 and monitor.divergences == 0
        assert server.batcher.stats["batched_steps"] > 0
    finally:
        model.close()

        async def down():
            await server.shutdown()
            await boot_node.shutdown()

        loop.run(down())
        loop.close()


# ------------------------------------------------------------------ the gate


def _perturbed_copy(model_path, dst):
    from safetensors.torch import load_file, save_file

    shutil.copytree(model_path, dst)
    for name in os.listdir(dst):
        if name.endswith(".safetensors"):
            tensors = load_file(os.path.join(dst, name))
            key = "model.layers.1.mlp.down_proj.weight"
            if key in tensors:
                tensors[key] = tensors[key] * 1.05
                save_file(tensors, os.path.join(dst, name), metadata={"format": "pt"})
    return dst


def _canary_round(loop, initial_peers):
    """One round of petals_tpu's canary and one of the port's, each from a
    fresh monitor; returns their reports."""

    async def probe():
        reports = []
        for cls in (JaxHealthMonitor, HealthMonitor):
            monitor = cls(initial_peers, port=0)
            await monitor.start()
            try:
                reports.append(await monitor.canary_probe())
            finally:
                await monitor.stop()
        return reports

    return loop.run(probe())


@pytest.mark.parametrize("perturbed", [False, True], ids=["honest", "perturbed"])
def test_canary_quorum_over_jax_and_port_replicas(model_path, tmp_path, perturbed):
    path = _perturbed_copy(model_path, str(tmp_path / "tiny-llama-perturbed")) if perturbed else model_path
    loop = Loop()
    prefix = default_dht_prefix(model_path)

    async def boot():
        boot_node = await JaxDHTNode.create(maintenance_period=1000)
        peers = [boot_node.own_addr.to_string()]
        servers = []
        for _ in range(2):
            s = JaxServer(model_path, first_block=0, num_blocks=N_LAYERS, initial_peers=[boot_node.own_addr],
                          compute_dtype=jnp.float32, use_flash=False, throughput=1.0)
            await s.start()
            servers.append(s)
        port = Server(path, first_block=0, num_blocks=N_LAYERS, initial_peers=peers, dht_prefix=prefix,
                      device="cpu", compute_dtype=torch.float32, throughput=1.0)
        await port.start()
        servers.append(port)
        return boot_node, servers

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path))
        boot_node, servers = loop.run(boot())
    port_peer = servers[-1].identity.peer_id.to_string()
    try:
        jax_reports, port_reports = _canary_round(loop, [boot_node.own_addr.to_string()])
        for reports in (jax_reports, port_reports):
            assert len(reports) == 1, reports
            report = reports[0]
            assert report["span"] == f"0:{N_LAYERS}" and len(report["probed"]) == 3 and not report["errors"]
            assert report["outliers"] == ([port_peer] if perturbed else []), report
        for registry in (jax_quarantine(), port_quarantine()):
            assert registry.is_quarantined(port_peer) == perturbed
            assert not any(registry.is_quarantined(s._identity.peer_id.to_string()) for s in servers[:-1])
    finally:
        for registry in (jax_quarantine(), port_quarantine()):
            registry.release(port_peer)

        async def down():
            for s in servers:
                await s.shutdown()
            await boot_node.shutdown()

        loop.run(down())
        loop.close()
