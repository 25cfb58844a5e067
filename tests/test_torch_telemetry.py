"""The port's telemetry plane against petals_tpu's, on the CPU in float32.

- ``render_prometheus`` of the same recorded values is byte-equal to
  petals_tpu's, and the instruments register the same names, help texts,
  label sets and bucket edges.
- After the same sequential traffic on a port server and a petals_tpu
  server, the deterministic counter deltas are equal: batched steps by
  variant and decode tokens, prefix-cache events, swaps and preemptions,
  migrations and handoffs, and (with a draft) speculative proposals and
  acceptances; the journal's event kinds come in the same order. Each
  package keeps its own registry and journal: the test compares deltas
  and resets neither.
- ``/metrics``, ``/journal`` and ``/ledger`` are served on an ephemeral
  port; ``ptu.info`` carries ``tracing``, ``telemetry`` and
  ``compile_stats`` with petals_tpu's keys, and the announce
  ``telemetry``, ``compile_stats``, ``integrity`` and ``metrics_port``.
- ``telemetry/trace.py`` normalizes trace ids as petals_tpu's does.

Every wait is bounded."""

import asyncio
import dataclasses
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.data_structures import CHAIN_DELIMITER, make_uid
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import serialize_array
from petals_tpu.server.server import Server as JaxServer
from petals_tpu.telemetry import exposition as JE
from petals_tpu.telemetry import instruments as JI
from petals_tpu.telemetry import registry as JR
from petals_tpu.telemetry import trace as JT
from petals_tpu.telemetry.journal import get_journal as jax_journal
from petals_tpu_torch.data_structures import ServerState
from petals_tpu_torch.server.server import Server, default_dht_prefix
from petals_tpu_torch.telemetry import exposition as TE
from petals_tpu_torch.telemetry import instruments as TI
from petals_tpu_torch.telemetry import registry as TR
from petals_tpu_torch.telemetry import trace as TT
from petals_tpu_torch.telemetry.journal import get_journal as port_journal
from tests.test_torch_spec_decode import _embed, _pooled_generate, spec_servers  # noqa: F401 (a fixture)
from tests.utils import make_tiny_llama

N_LAYERS = 4

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


# ------------------------------------------------------------------ exposition


def _record(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("t_requests_total", "Requests, by \"kind\"\nand line", labels=("kind",))
    g = reg.gauge("t_free", "Free pages")
    h = reg.histogram("t_step_seconds", "Step wall", labels=("variant",))
    c.labels(kind="a\\b").inc(3)
    c.labels(kind='q"x').inc()
    g.set(7.5)
    for v, variant in ((0.0003, "paged"), (0.02, "paged"), (3.0, "mixed"), (99.0, "mixed")):
        h.labels(variant=variant).observe(v)
    for i in range(70):  # past the label cap: the overflow series
        c.labels(kind=f"k{i}").inc()
    return reg


def test_render_prometheus_is_byte_equal():
    got = TE.render_prometheus(_record(TR))
    want = JE.render_prometheus(_record(JR))
    assert got == want and "t_step_seconds_bucket" in got and "_overflow" in got


def test_instruments_match_petals_tpu():
    def shape(reg):
        return {m.name: (m.kind, m.help, tuple(m.labelnames), tuple(getattr(m, "buckets", ()) or ()))
                for m in reg.collect() if m.name.startswith(("petals_", "telemetry_"))}

    assert shape(TI.REGISTRY) == shape(JI.REGISTRY)


@pytest.mark.parametrize("value", ["abc-DEF_123", "x" * 64, "x" * 65, "", "a b", "é", None, 7, "../x", "ok_1"])
def test_trace_ids_normalize_as_petals_tpu(value):
    assert TT.normalize_trace_id(value) == JT.normalize_trace_id(value)
    assert len(TT.new_trace_id()) == len(JT.new_trace_id()) == 16


# ------------------------------------------------------------------ the same traffic

COUNTERS = ("petals_batched_steps_total", "petals_decode_tokens_total", "petals_prefix_cache_events_total",
            "petals_swap_bytes_total", "petals_preemptions_total", "petals_allocation_failed_total",
            "petals_migrations_total", "petals_migration_bytes_total", "petals_handoffs_total",
            "petals_handoff_bytes_total", "petals_spec_proposed_tokens_total",
            "petals_spec_accepted_tokens_total")
SCHEDULER_KINDS = ("admission", "waiter_picked", "victim_selected", "swap_out", "swap_in", "noisy_neighbor",
                   "spec_disabled", "migrate_in", "migrate_refused", "migrate_adopt", "migrate_out",
                   "migrate_failed", "migrate_aborted", "handoff_out", "handoff_failed", "handoff_aborted")


def _counters(registry) -> dict:
    snap = registry.snapshot()
    return {(name, key): value for name in COUNTERS for key, value in snap[name]["series"].items()}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


async def _start(kind, model_path, **kw):
    if kind == "port":
        server = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", compute_dtype=torch.float32,
                        throughput=1.0, **kw)
        await server.start()
        addr = server.contact_addr.to_string()
    else:
        server = JaxServer(model_path, compute_dtype=jnp.float32, use_flash=False, throughput=1.0, batching=True,
                           **kw)
        await server.start()
        addr = server.contact_addr.to_string()
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    return server, client, addr


def _uids(model_path):
    return CHAIN_DELIMITER.join(make_uid(default_dht_prefix(model_path), i) for i in range(N_LAYERS))


async def _open(client, model_path, session_id=None, max_length=256):
    stream = await client.open_stream("ptu.inference")
    msg = {"uids": _uids(model_path), "max_length": max_length, "batch_size": 1}
    if session_id:
        msg["session_id"] = session_id
    await stream.send(msg)
    assert (await stream.recv(timeout=60))["session_open"]
    return stream


async def _step(stream, h):
    await stream.send({"tensors": {"hidden": serialize_array(h)}})
    return await stream.recv(timeout=120)


async def _prefix_and_handoff(kind, model_path, prompts):
    """Two sessions on one prompt of 150 tokens (a prefix miss and store,
    then a hit whose lane adopts the pinned pages), each with 3 decode
    steps; a session handed off to the server itself (its KV pushed to its
    own ``ptu.session_migrate``) and one to a dead address."""
    server, client, addr = await _start(kind, model_path, batch_lanes=2, batch_max_length=256, page_size=16)
    try:
        prompt, steps = prompts
        for _ in range(2):
            stream = await _open(client, model_path)
            await _step(stream, prompt)
            for h in steps:
                await _step(stream, h)
            await stream.end()
        stream = await _open(client, model_path, session_id=f"h-{kind}")
        await _step(stream, prompt[:, :20])
        peer = addr.split("/")[1]
        ok = await client.call("ptu.session_handoff", {"session_id": f"h-{kind}", "peer_id": peer, "addr": addr,
                                                       "deadline_s": 30}, timeout=60)
        dead = await client.call("ptu.session_handoff", {"session_id": f"h-{kind}", "peer_id": peer,
                                                         "addr": f"127.0.0.1:1/{peer}", "deadline_s": 5}, timeout=60)
        assert ok["ok"] and not dead["ok"], (ok, dead)
        await stream.end()
    finally:
        await client.close()
        await server.shutdown()


async def _swaps(kind, model_path, hsz):
    """Two sessions on a pool of 3 pages of 16 tokens with a swap tier: C
    prefills 30 tokens; D's admission takes the last page, and its 30-token
    prefill preempts the idle C; C's next step swaps it back in, preempting
    the idle D."""
    server, client, _ = await _start(kind, model_path, batch_lanes=2, batch_max_length=48, page_size=16,
                                     n_pages=3, swap_host_bytes=1 << 26, prefix_cache_bytes=0,
                                     prefix_device_bytes=0)
    try:
        rng = np.random.RandomState(31)
        c = await _open(client, model_path, max_length=48)
        await _step(c, (rng.randn(1, 30, hsz) * 0.1).astype(np.float32))
        d = await _open(client, model_path, max_length=48)
        await _step(d, (rng.randn(1, 30, hsz) * 0.1).astype(np.float32))
        await _step(c, (rng.randn(1, 1, hsz) * 0.1).astype(np.float32))
        await c.end()
        await d.end()
    finally:
        await client.close()
        await server.shutdown()


def _traffic(kind, model_path, hsz):
    registry = TR.get_registry() if kind == "port" else JR.get_registry()
    journal = port_journal() if kind == "port" else jax_journal()
    rng = np.random.RandomState(29)
    prompts = ((rng.randn(1, 150, hsz) * 0.1).astype(np.float32),
               [(rng.randn(1, 1, hsz) * 0.1).astype(np.float32) for _ in range(3)])
    before, seq = _counters(registry), max((e["seq"] for e in journal.events()), default=0)
    asyncio.run(_prefix_and_handoff(kind, model_path, prompts))
    asyncio.run(_swaps(kind, model_path, hsz))
    kinds = [e["kind"] for e in journal.events(since_seq=seq) if e["kind"] in SCHEDULER_KINDS]
    return _delta(_counters(registry), before), kinds


def test_counter_deltas_and_journal_equal_petals_tpu(model_path, monkeypatch):
    from petals_tpu_torch.server.from_pretrained import get_block_config

    # petals_tpu's failed push files flight evidence through
    # flight_from_env(), which is None (and the RPC fails) unless an SLO is
    # configured: one is, far above anything this traffic takes
    monkeypatch.setenv("PETALS_TPU_SLO_TTFT_MS", "600000")
    hsz = get_block_config(model_path)[1].hidden_size
    port, port_kinds = _traffic("port", model_path, hsz)
    ref, ref_kinds = _traffic("jax", model_path, hsz)
    assert port == ref
    # the traffic reached every family of counters it was built for
    for name in ("petals_batched_steps_total", "petals_decode_tokens_total", "petals_prefix_cache_events_total",
                 "petals_swap_bytes_total", "petals_preemptions_total", "petals_migrations_total",
                 "petals_migration_bytes_total", "petals_handoffs_total", "petals_handoff_bytes_total"):
        assert any(k[0] == name for k in port), (name, port)
    assert port[("petals_prefix_cache_events_total", "event=hit")] == 1
    assert port[("petals_handoffs_total", "outcome=ok")] == port[("petals_handoffs_total", "outcome=failed")] == 1
    assert port_kinds == ref_kinds and "swap_out" in port_kinds and "handoff_out" in port_kinds


def test_spec_counter_deltas_equal_petals_tpu(spec_servers):
    loop = spec_servers["loop"]
    ctx = [int(t) for t in np.random.default_rng(23).integers(0, 100, 7)]
    deltas = {}
    for kind, registry in (("port", TR.get_registry()), ("jax", JR.get_registry())):
        server = spec_servers[kind]
        batcher = server.batcher if kind == "port" else server.handler.batcher
        before = _counters(registry)
        loop.run(_pooled_generate(batcher, _embed(batcher, ctx, kind == "port"), 14, {"context": ctx}))
        deltas[kind] = _delta(_counters(registry), before)
    assert deltas["port"] == deltas["jax"]
    assert deltas["port"][("petals_spec_proposed_tokens_total", "_")] > 0
    assert deltas["port"][("petals_spec_accepted_tokens_total", "_")] > 0
    assert deltas["port"][("petals_batched_steps_total", "variant=spec")] > 0


# ------------------------------------------------------------------ endpoints and announce


def _get(port, path):
    """(status, content type, body) of a GET on the metrics endpoint."""
    import urllib.error

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, ""


def test_endpoints_info_and_announce(model_path):
    async def main():
        port_server, client, _ = await _start("port", model_path, metrics_port=0, batch_lanes=2,
                                              batch_max_length=64, page_size=16)
        jax_server, jax_client, _ = await _start("jax", model_path, metrics_port=0, batch_lanes=2,
                                                 batch_max_length=64, page_size=16)
        try:
            stream = await _open(client, model_path, max_length=64)
            reply = await _step(stream, np.zeros((1, 9, port_server.cfg.hidden_size), np.float32))
            await stream.end()
            info = await client.call("ptu.info", {}, timeout=30)
            jax_info = await jax_client.call("ptu.info", {}, timeout=30)
            announce = dataclasses.asdict(port_server._server_info(ServerState.ONLINE))
            jax_announce = jax_server._server_info(ServerState.ONLINE)
            mport = port_server._metrics_server.port
            pages = [await asyncio.to_thread(_get, mport, p) for p in ("/metrics", "/journal", "/ledger", "/nope")]
            return info, jax_info, announce, jax_announce, mport, pages, reply
        finally:
            await client.close()
            await jax_client.close()
            await port_server.shutdown()
            await jax_server.shutdown()

    info, jax_info, announce, jax_announce, mport, pages, reply = asyncio.run(main())
    assert set(jax_info) - {"adapters"} <= set(info)
    assert {"tracing", "telemetry", "compile_stats"} <= set(info)
    assert set(info["telemetry"]) == set(jax_info["telemetry"])
    assert {"functions", "programs", "compile_s", "anomalies"} <= set(info["compile_stats"])
    assert info["tracing"]["inference_step"]["count"] >= 1
    assert announce["metrics_port"] == mport
    assert set(announce["telemetry"]) == set(jax_announce.telemetry)
    assert set(announce["integrity"]) == set(jax_announce.integrity) == {"self_digest", "fp_seed", "span",
                                                                          "quarantined"}
    # the same weights in float32 self-probe to the same digest
    assert announce["integrity"]["self_digest"] == jax_announce.integrity["self_digest"]
    assert announce["integrity"]["span"] == f"0:{N_LAYERS}" and announce["compile_stats"] is not None
    (s1, t1, metrics), (s2, t2, journal), (s3, t3, ledger), (s4, _, _) = pages
    assert s1 == s2 == s3 == 200 and s4 == 404
    assert t1.startswith("text/plain") and t2 == "application/x-ndjson" and t3 == "application/json"
    assert "petals_batched_steps_total" in metrics and "petals_reply_serialize_seconds_bucket" in metrics
    kinds = {json.loads(line)["kind"] for line in journal.splitlines() if line.strip()}
    assert "admission" in kinds
    assert {"peers", "sessions"} <= set(json.loads(ledger))
    assert reply["step_meta"]["variant"] == "prefill"


def test_trace_dir_writes_a_chrome_trace_of_its_window(model_path, tmp_path, monkeypatch):
    """``trace_dir``: a torch.profiler capture from startup, written as a
    Chrome trace when its window ends (here 0.5 s)."""
    monkeypatch.setenv("PETALS_TPU_TRACE_SECONDS", "0.5")

    async def main():
        server, client, _ = await _start("port", model_path, trace_dir=str(tmp_path))
        try:
            payload = {"uids": _uids(model_path), "tensors": {"hidden": serialize_array(
                np.zeros((1, 8, server.cfg.hidden_size), np.float32))}}
            await client.call("ptu.forward", payload, timeout=60)
            for _ in range(200):  # the window ends, then the file lands
                if list(tmp_path.glob("trace_*.json")):
                    break
                await asyncio.sleep(0.05)
        finally:
            await client.close()
            await server.shutdown()

    asyncio.run(main())
    (trace,) = tmp_path.glob("trace_*.json")
    assert "traceEvents" in json.loads(trace.read_text())
