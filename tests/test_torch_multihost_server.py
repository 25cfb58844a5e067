"""Multi-host lockstep serving end to end in the port: ``run_server``
(the leader) and ``run_worker`` as two CLI processes over gloo, tp=2 with
one CPU shard a process, float32, on tiny-llama.

- (c) The port client's greedy stream over the pair, through the dense lane
  pool's pooled sessions (the leader gates server-side generation off under
  lockstep, as petals_tpu's does), equals a JAX client's over a petals_tpu
  ``Server(num_tp_devices=2)``; a 150-token prompt's second session seeds
  from the prefix cache (host copies, stored through the group's export).
- (d) A session exported from the pair (a pooled one at batch 1, a private
  one at batch 2: the group's export gathers every process's heads) and
  imported into an unsharded port server exports the same bytes there; the
  next chunk's outputs agree within float32's 2e-5.
- (f) A leader ``Server`` beside a ``run_worker`` (tests/
  torch_multihost_child.py ``server``; auto-throughput probed on the
  group, halved at re-formation): its session's outputs before a
  live span move, after it (pooled and private), and after the worker is
  killed and the announce loop's health check re-formed it single-host,
  each equal the one-process backend's over the same blocks within 2e-5.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array
from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from tests.test_torch_client import Loop, Route
from tests.test_torch_kv_transfer import _open, _step, _uids
from tests.test_torch_multihost import REPO, TOL, child_env, free_port, kill_all
from tests.torch_multihost_child import inputs
from tests.utils import make_tiny_llama

N_LAYERS = 4
IDS = np.random.RandomState(0).randint(1, 100, (1, 5)).astype(np.int64)
# a prompt past the prefix cache's 128-token segment: its second session
# seeds its lane from the cache (an import broadcast to the worker)
LONG_IDS = np.random.RandomState(1).randint(1, 100, (1, 150)).astype(np.int64)
N_NEW = 6


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


def _wait_line(proc, prefix_ok, timeout: float) -> str:
    """The first line of ``proc``'s stdout that ``prefix_ok`` accepts."""
    deadline = time.monotonic() + timeout
    seen = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                break
            continue
        seen.append(line)
        if prefix_ok(line):
            return line.strip()
    raise AssertionError("".join(seen)[-4000:])


@pytest.fixture(scope="module")
def cli_pair(model_path, tmp_path_factory):
    """A DHT bootstrap, the run_server leader and one run_worker, tp=2."""
    from petals_tpu.dht import DHTNode as JaxDHTNode

    tmp = tmp_path_factory.mktemp("pair")
    loop = Loop()
    boot = loop.run(JaxDHTNode.create(maintenance_period=1000))
    coord = f"127.0.0.1:{free_port()}"
    env = dict(child_env(), PETALS_TPU_TORCH_CACHE=str(tmp / "cache"))
    common = ["--first_block", "0", "--num_blocks", str(N_LAYERS), "--num_tp_devices", "2", "--torch_dtype",
              "float32", "--device", "cpu", "--coordinator_address", coord, "--num_hosts", "2"]
    leader = subprocess.Popen(
        [sys.executable, "-m", "petals_tpu_torch.cli.run_server", model_path, *common, "--initial_peers",
         boot.own_addr.to_string(), "--throughput", "1", "--update_period", "5"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=open(tmp / "leader.log", "w"), text=True)
    worker = subprocess.Popen(
        [sys.executable, "-m", "petals_tpu_torch.cli.run_worker", model_path, *common, "--host_index", "1"],
        cwd=REPO, env=env, stdout=open(tmp / "worker.log", "w"), stderr=subprocess.STDOUT)
    try:
        addr = _wait_line(leader, lambda ln: "/" in ln and ":" in ln, 150)
        yield {"boot": boot, "addr": addr, "loop": loop, "logs": tmp}
    finally:
        leader.terminate()
        try:
            leader.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass
        kill_all([leader, worker])
        loop.run(boot.shutdown())
        loop.close()


@pytest.fixture(scope="module")
def jax_stream(model_path, tmp_path_factory):
    """A JAX client's greedy stream over a petals_tpu TP=2 server."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    route = Route(model_path, [("jax", 0, N_LAYERS, dict(num_tp_devices=2))], str(tmp_path_factory.mktemp("j"))).start()
    try:
        model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
        try:
            return model.generate(IDS, max_new_tokens=N_NEW), model.generate(LONG_IDS, max_new_tokens=N_NEW)
        finally:
            model.close()
    finally:
        route.stop()


@pytest.mark.timeout(300)
def test_cli_pair_serves_the_jax_tp_stream(model_path, cli_pair, jax_stream):
    model = AutoDistributedModelForCausalLM.from_pretrained(
        model_path, initial_peers=[cli_pair["boot"].own_addr.to_string()], device="cpu")
    short, long = jax_stream
    try:
        for _ in range(2):  # a second session reuses the pool's lanes; the long one hits the prefix cache
            np.testing.assert_array_equal(model.generate(IDS, max_new_tokens=N_NEW), short)
            np.testing.assert_array_equal(model.generate(LONG_IDS, max_new_tokens=N_NEW), long)
    finally:
        model.close()
    info = cli_pair["loop"].run(_info(cli_pair["addr"]))
    cb = info["continuous_batching"]
    # the dense lane pool served it: no paging, batched decode steps, no server-side generation
    assert cb["page_size"] is None and cb["decode_steps"] > 0 and cb["gen_steps"] == 0, cb
    # the first long session stored its segment through the group's export, the second seeded from it
    pc = info["prefix_cache"]
    assert pc["segments"] >= 1 and pc["hits"] >= 1 and pc["device_segments"] == 0, pc


async def _info(addr):
    host, rest = addr.split(":", 1)
    client = await RpcClient.connect(host, int(rest.split("/")[0]))
    try:
        return await client.call("ptu.info", {})
    finally:
        await client.close()


def _tensors(export):
    return {name: np.asarray(deserialize_array(t)) for name, t in export["tensors"].items()}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("batch", [1, 2], ids=["pooled", "private"])
def test_exported_session_imports_byte_for_byte(model_path, cli_pair, tmp_path, batch):
    loop = cli_pair["loop"]
    route = Route(model_path, [("port", 0, N_LAYERS)], str(tmp_path), server_side_generation=False,
                  prefix_cache_bytes=0).start()
    host, rest = cli_pair["addr"].split(":", 1)
    try:
        plain = route.servers[0]
        uids = _uids(model_path)
        rng = np.random.RandomState(batch)
        prefill = rng.randn(batch, 9, plain.cfg.hidden_size).astype(np.float32) * 0.5
        chunk = rng.randn(batch, 8, plain.cfg.hidden_size).astype(np.float32) * 0.5

        async def scenario():
            src = await RpcClient.connect(host, int(rest.split("/")[0]))
            dst = await RpcClient.connect(plain.host, plain.rpc_server.port)
            try:
                a = await _open(src, uids, f"mh-src-{batch}", batch_size=batch)
                await _step(a, prefill)
                first = await src.call("ptu.session_export",
                                       {"session_id": f"mh-src-{batch}", "start": 0, "end": N_LAYERS})
                b = await _open(dst, uids, f"mh-dst-{batch}", batch_size=batch)
                await b.send({"kv_import": {"position": 9}, "tensors": first["tensors"]})
                assert (await b.recv(timeout=60))["kv_import"]
                again = await dst.call("ptu.session_export",
                                       {"session_id": f"mh-dst-{batch}", "start": 0, "end": N_LAYERS})
                want, got = await _step(a, chunk), await _step(b, chunk)
                await a.end()
                await b.end()
                return first, again, want, got
            finally:
                await src.close()
                await dst.close()

        first, again, want, got = loop.run(scenario())
    finally:
        route.stop()
    assert first["position"] == again["position"] == 9
    for name, arr in _tensors(first).items():
        assert arr.shape == (N_LAYERS, batch, 9, 2, 16)
        np.testing.assert_array_equal(_tensors(again)[name].view(np.uint8), arr.view(np.uint8), err_msg=name)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _reference(model_path, first: int, batch: int) -> np.ndarray:
    """Blocks [first, first + 2) on the port's one-process backend: the
    child's session (a prefill, then one step)."""
    family, cfg = get_block_config(model_path)
    blocks = [load_block_params(model_path, i, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
              for i in range(first, first + 2)]
    b = TransformerBackend(family, cfg, blocks, first_block=first, n_blocks=2, device="cpu",
                           compute_dtype=torch.float32, use_flash=False)
    x = inputs(cfg.hidden_size, N_LAYERS)
    kv = tuple(d.make_zeros() for d in b.cache_descriptors(batch, 32, 0, 2))
    out1, _ = b.inference_step(torch.from_numpy(x["prefill"][:batch]), kv, 0)
    out2, _ = b.inference_step(torch.from_numpy(x["step"][:batch]), kv, 6)
    return torch.cat([out1, out2], dim=1).numpy()


@pytest.mark.timeout(300)
def test_span_move_and_single_host_reformation_serve_the_reference(model_path, tmp_path):
    coord = f"127.0.0.1:{free_port()}"
    out = str(tmp_path / "server.npz")
    env = dict(child_env(), PETALS_TPU_TORCH_CACHE=str(tmp_path / "cache"))
    leader = subprocess.Popen(
        [sys.executable, "-m", "tests.torch_multihost_child", "server", model_path, coord, "2", "0", "2", "1", out],
        cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=open(tmp_path / "leader.log", "w"),
        text=True)
    worker = subprocess.Popen(
        [sys.executable, "-m", "petals_tpu_torch.cli.run_worker", model_path, "--coordinator_address", coord,
         "--num_hosts", "2", "--host_index", "1", "--first_block", "0", "--num_blocks", "2", "--num_tp_devices",
         "2", "--torch_dtype", "float32", "--device", "cpu"],
        cwd=REPO, env=env, stdout=open(tmp_path / "worker.log", "w"), stderr=subprocess.STDOUT)
    try:
        _wait_line(leader, lambda ln: ln.startswith("KILL_WORKER"), 200)
        worker.kill()
        worker.wait(timeout=30)
        leader.stdin.write("go\n")
        leader.stdin.flush()
        rest, _ = leader.communicate(timeout=200)
        assert leader.returncode == 0, rest + (tmp_path / "leader.log").read_text()[-4000:]
        assert "DEGRADED_STEP" in rest, rest
    finally:
        kill_all([leader, worker])
    got = dict(np.load(out))
    assert int(got["degraded"]) == 1 and int(got["reformed_hosts"]) == 1
    # auto-throughput came from the group's own probe; re-formation keeps
    # the width this process holds (1 of the group's 2 devices)
    assert float(got["forward_rps"]) > 0 and float(got["throughput"]) > 0
    np.testing.assert_allclose(float(got["reformed_throughput"]), float(got["throughput"]) / 2, rtol=1e-6)
    np.testing.assert_allclose(got["before"], _reference(model_path, 0, 1), atol=TOL, rtol=0)
    moved = _reference(model_path, 2, 1)
    np.testing.assert_allclose(got["moved"], moved, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["moved_private"], _reference(model_path, 2, 2), atol=TOL, rtol=0)
    np.testing.assert_allclose(got["reformed"], moved, atol=TOL, rtol=0)
