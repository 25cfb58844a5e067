"""The port's swarm health monitor and ``run_health`` against petals_tpu's.

- ``HealthMonitor`` end to end (tests/test_health.py:174's loop, all of it
  the port's: DHT, server, monitor): the monitor discovers the model and
  its coverage, serves ``/api/v1/state``, the HTML page,
  ``/api/v1/metrics`` (with the server's announced telemetry,
  compile_stats and integrity) and the reachability API.
- ``run_health --waterfall`` prints petals_tpu's output for a saved trace
  report, and for a flight-recorder entry that wraps one.

Every wait is bounded."""

import asyncio
import contextlib
import io
import json
import urllib.request

import pytest
import torch

from petals_tpu.cli import run_health as jax_run_health
from petals_tpu.telemetry.spans import HopTrace as JaxHopTrace
from petals_tpu.telemetry.spans import build_trace_report
from petals_tpu_torch.cli import run_health
from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.utils.health import HealthMonitor
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)


def test_health_monitor_e2e(tmp_path, monkeypatch):
    monkeypatch.setenv("PETALS_TPU_TORCH_CACHE", str(tmp_path / "cache"))

    async def scenario():
        bootstrap = await DHTNode.create()
        path = make_tiny_llama(str(tmp_path))
        server = Server(path, initial_peers=[bootstrap.own_addr.to_string()], first_block=0, num_blocks=4,
                        device="cpu", compute_dtype=torch.float32, throughput=1.0, metrics_port=0)
        await server.start()
        monitor = HealthMonitor([bootstrap.own_addr.to_string()], update_period=600)
        await monitor.start()
        try:
            state = await monitor.refresh()
            assert server.dht_prefix in state["models"]
            model = state["models"][server.dht_prefix]
            assert model["healthy"] and model["blocks_covered"] == 4
            peer_hex = server.identity.peer_id.to_string()
            row = model["servers"][peer_hex]
            assert row["state"] == "ONLINE" and row["blocks"] == [0, 4]
            assert row["integrity"]["span"] == "0:4" and row["telemetry"] is not None
            assert row["compile_stats"] is not None

            base = f"http://127.0.0.1:{monitor.port}"

            def fetch(url):
                with urllib.request.urlopen(url, timeout=10) as r:
                    return r.read()

            api = json.loads(await asyncio.to_thread(fetch, base + "/api/v1/state"))
            assert api["models"][server.dht_prefix]["healthy"]
            page = (await asyncio.to_thread(fetch, base + "/")).decode()
            assert "swarm health" in page and server.dht_prefix in page
            metrics = json.loads(await asyncio.to_thread(fetch, base + "/api/v1/metrics"))
            agg = metrics["models"][server.dht_prefix]["aggregate"]
            assert agg["servers_reporting"] == 1 and agg["quarantined_servers"] == 0
            reach = json.loads(await asyncio.to_thread(fetch, f"{base}/api/v1/is_reachable/{peer_hex}"))
            assert reach["ok"] and not reach["relayed"]
            # one replica: nothing to compare a canary against
            assert await monitor.canary_probe() == []
        finally:
            await monitor.stop()
            await server.shutdown()
            await bootstrap.shutdown()

    asyncio.run(asyncio.wait_for(scenario(), 240))


def _report():
    hops = []
    for i, (peer, blocks) in enumerate((("peer-a" * 8, (0, 2)), ("peer-b" * 8, (2, 4)))):
        hop = JaxHopTrace(peer, *blocks)
        hop.record(0.02 + i * 0.01, {"queue_s": 0.004, "compute_s": 0.009, "serialize_s": 0.001, "total_s": 0.015,
                                     "variant": "prefill", "busy_lanes": 1, "lane_waiters": 0}, tokens=4)
        hop.record(0.01, {"queue_s": 0.0, "compute_s": 0.006, "serialize_s": 0.0005, "total_s": 0.007,
                          "variant": "decode"})
        hops.append(hop)
    return build_trace_report("abc123", hops, wall_s=0.07, steps=2, tokens=5)


@pytest.mark.parametrize("wrapped", [False, True], ids=["report", "flight_entry"])
def test_run_health_waterfall_prints_petals_tpus_output(tmp_path, wrapped):
    report = _report()
    doc = {"kind": "ttft", "trace_id": "abc123", "waterfall": report} if wrapped else report
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(doc))
    outs = []
    for main in (run_health.main, jax_run_health.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--waterfall", str(path)])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "abc123" in outs[0] and "critical path:" in outs[0]
