"""The port client's critical-path profiler against petals_tpu's.

- Over one chain (a petals_tpu server on blocks [0, 2), a port server on
  [2, 4), each with ``/metrics``), the port's ``InferenceSession`` and
  petals_tpu's step the same inputs: their ``trace_report()`` have the same
  keys, the same hops (blocks, steps, step_meta steps, tokens, the keys of
  each hop's entry), the same step and token totals, and ~all of the wall
  attributed.
- ``format_waterfall`` renders the same text as petals_tpu's for the same
  report.
- With SLOs set in the environment (``PETALS_TPU_SLO_TTFT_MS``,
  ``PETALS_TPU_SLO_TOKEN_MS``) the port session's flight recorder fires on
  the first step and on a token step, with the waterfall and the
  critical-path server's journal excerpt for the session's trace id.

Every wait is bounded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.config import ClientConfig as JaxClientConfig
from petals_tpu.client.inference_session import InferenceSession as JaxSession
from petals_tpu.client.routing.sequence_manager import RemoteSequenceManager as JaxManager
from petals_tpu.data_structures import make_uid
from petals_tpu.dht import DHTNode as JaxDHTNode
from petals_tpu.server.server import Server as JaxServer
from petals_tpu.telemetry.spans import format_waterfall as jax_waterfall
from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.inference_session import InferenceSession
from petals_tpu_torch.client.routing.sequence_manager import RemoteSequenceManager
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.telemetry.spans import format_waterfall
from tests.test_torch_swarm import Loop
from tests.utils import make_tiny_llama

N_LAYERS = 4

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def chain(model_path, tmp_path_factory):
    loop = Loop()

    async def boot():
        boot_node = await JaxDHTNode.create(maintenance_period=1000)
        jax_server = JaxServer(model_path, first_block=0, num_blocks=2, initial_peers=[boot_node.own_addr],
                               compute_dtype=jnp.float32, use_flash=False, throughput=1.0, batch_lanes=2,
                               batch_max_length=32, page_size=8, metrics_port=0)
        await jax_server.start()
        port = Server(model_path, first_block=2, num_blocks=2, initial_peers=[boot_node.own_addr.to_string()],
                      device="cpu", compute_dtype=torch.float32, throughput=1.0, batch_lanes=2,
                      batch_max_length=32, page_size=8, metrics_port=0)
        await port.start()
        return boot_node, jax_server, port

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path_factory.mktemp("cache")))
        boot_node, jax_server, port = loop.run(boot())
    uids = [make_uid(jax_server.dht_prefix, i) for i in range(N_LAYERS)]
    peers = [boot_node.own_addr.to_string()]
    yield loop, peers, uids, port

    async def down():
        await port.shutdown()
        await jax_server.shutdown()
        await boot_node.shutdown()

    loop.run(down())
    loop.close()


def _inputs(hsz):
    rng = np.random.RandomState(7)
    return [(rng.randn(1, n, hsz) * 0.1).astype(np.float32) for n in (4, 1, 1, 1)]


def _run(loop, make_manager, make_session, inputs, flight_env=None):
    async def go():
        manager = await make_manager()
        try:
            session = make_session(manager)
            for h in inputs:
                await session.step(h)
            report = session.trace_report()
            flight = session.flight
            await session.close()
            return report, flight, session.trace_id
        finally:
            await manager.shutdown()

    return loop.run(go())


@pytest.fixture(scope="module")
def reports(chain):
    loop, peers, uids, port = chain
    inputs = _inputs(port.cfg.hidden_size)
    got = _run(loop, lambda: RemoteSequenceManager.create(ClientConfig(initial_peers=peers), uids),
               lambda m: InferenceSession(m, max_length=16), inputs)
    want = _run(loop, lambda: JaxManager.create(JaxClientConfig(initial_peers=peers), uids),
                lambda m: JaxSession(m, max_length=16), inputs)
    return got[0], want[0]


def test_trace_report_has_the_jax_sessions_keys_and_hops(reports):
    got, want = reports
    assert set(got) == set(want)
    assert (got["steps"], got["tokens"], got["retired_hops"]) == (want["steps"], want["tokens"],
                                                                   want["retired_hops"]) == (4, 7, 0)
    assert [h["blocks"] for h in got["hops"]] == [h["blocks"] for h in want["hops"]] == [[0, 2], [2, 4]]
    for g, w in zip(got["hops"], want["hops"]):
        assert set(g) == set(w) and set(g["components"]) == set(w["components"])
        assert (g["steps"], g["meta_steps"], g["tokens"]) == (w["steps"], w["meta_steps"], w["tokens"]) == (4, 4, 7)
        assert g["components"]["compute"] > 0 and g["occupancy"] is not None
        assert g["peer"] == w["peer"]  # the same servers, in order
    assert got["critical_path"] is not None and set(got["critical_path"]) == set(want["critical_path"])
    assert got["attributed_fraction"] >= 0.95, got
    assert set(got["totals"]) == set(want["totals"])


def test_format_waterfall_renders_the_same_text(reports):
    for report in reports:
        text = format_waterfall(report)
        assert text == jax_waterfall(report)
        assert report["trace_id"] in text and "critical path:" in text


def test_flight_recorder_fires_on_an_env_slo_breach(chain, monkeypatch):
    loop, peers, uids, port = chain
    monkeypatch.setenv("PETALS_TPU_SLO_TTFT_MS", "0.000001")
    monkeypatch.setenv("PETALS_TPU_SLO_TOKEN_MS", "0.000001")
    _, flight, trace_id = _run(loop, lambda: RemoteSequenceManager.create(ClientConfig(initial_peers=peers), uids),
                               lambda m: InferenceSession(m, max_length=16), _inputs(port.cfg.hidden_size)[:2])
    assert flight is not None
    ttft, token = flight.entries(kind="ttft"), flight.entries(kind="token")
    assert len(ttft) == 1 and len(token) == 1
    for entry in ttft + token:
        assert entry["trace_id"] == trace_id and entry["observed_s"] > entry["slo_s"]
        assert entry["waterfall"]["trace_id"] == trace_id and entry["waterfall"]["hops"]
        journal = entry["server_journal"]
        assert "error" not in journal, journal
        assert journal["events"] and all(e["trace_id"] == trace_id for e in journal["events"])
        assert any(e["kind"] == "admission" for e in journal["events"])
