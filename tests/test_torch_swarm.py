"""A mixed swarm on loopback: a petals_tpu DHT bootstrap, one petals_tpu
Server on 2 of tiny-llama's 4 blocks, and one port Server (CPU, float32)
that the DHT places on the other 2. Parametrized over which kind holds the
first half. A petals_tpu client (AutoDistributedModelForCausalLM) reaches
the port server only through the DHT, as it reaches any server.

- Greedy and seeded sampled generation over the mixed chain give token
  streams identical to those over an all-petals_tpu swarm of two servers on
  the same halves, and the greedy stream equals HF's.
- The port's announcement, read back by petals_tpu's
  get_remote_module_infos / compute_spans, carries state, span, version,
  a measured throughput, quant_type, compute_dtype and server_gen=False;
  after the port server shuts down its record reads OFFLINE.
- The session-open ack echoes the client's trace_id (normalized, or minted).
- The CLIs parse and build: run_dht, and run_server with --initial_peers and
  no --first_block.

Every wait is bounded (``Loop.run``'s timeout, or the generate call's own
RPC timeouts); no test starts more than two servers."""

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petals_tpu_torch
from petals_tpu.client.model import AutoDistributedModelForCausalLM
from petals_tpu.data_structures import CHAIN_DELIMITER, ServerState, make_uid
from petals_tpu.dht import DHTNode as JaxDHTNode
from petals_tpu.rpc import RpcClient
from petals_tpu.server.server import Server as JaxServer
from petals_tpu.utils.dht_utils import compute_spans, get_remote_module_infos
from petals_tpu_torch.server.server import Server, default_dht_prefix
from tests.utils import make_tiny_llama

N_LAYERS = 4
HALF = 2
MAX_NEW_TOKENS = 8
SAMPLING = dict(do_sample=True, top_k=10, temperature=0.8, seed=7)  # tests/test_full_model.py's
TIMEOUT = 300

pytestmark = pytest.mark.timeout(600)


class Loop:
    """An event loop on a thread of its own, holding the swarm's nodes."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self._thread.start()

    def run(self, coro, timeout=TIMEOUT):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=10)


def _jax_server(path, bootstrap, first_block):
    return JaxServer(
        path, first_block=first_block, num_blocks=HALF, initial_peers=[bootstrap.own_addr],
        compute_dtype=jnp.float32, use_flash=False, throughput=1.0,
    )


class Swarm:
    """A bootstrap and two servers; ``kinds`` names them in block order."""

    def __init__(self, path, kinds, cache_dir):
        self.path, self.kinds, self.cache_dir = path, kinds, cache_dir
        self.loop = Loop()
        self.servers = []
        self.port_server = None

    def start(self):
        async def boot():
            self.bootstrap = await JaxDHTNode.create(maintenance_period=1000)
            # the petals_tpu servers take their halves; the port server is
            # placed by the DHT on whatever half is left
            for i, kind in enumerate(self.kinds):
                if kind == "jax":
                    server = _jax_server(self.path, self.bootstrap, i * HALF)
                    await server.start()
                    self.servers.append(server)
            for kind in self.kinds:
                if kind == "port":
                    server = Server(
                        self.path, num_blocks=HALF, initial_peers=[self.bootstrap.own_addr.to_string()],
                        device="cpu", compute_dtype=torch.float32,
                    )
                    await server.start()
                    self.servers.append(server)
                    self.port_server = server

        with pytest.MonkeyPatch.context() as mp:  # the port server's throughput cache
            mp.setenv("PETALS_TPU_TORCH_CACHE", self.cache_dir)
            self.loop.run(boot())
        return self

    @property
    def initial_peers(self):
        return [self.bootstrap.own_addr.to_string()]

    def stop(self):
        async def teardown():
            for server in self.servers:
                await server.shutdown()
            await self.bootstrap.shutdown()

        self.loop.run(teardown())
        self.loop.close()


def _streams(path, initial_peers, input_ids):
    model = AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=initial_peers)
    try:
        greedy = model.generate(input_ids, max_new_tokens=MAX_NEW_TOKENS)
        sampled = model.generate(input_ids, max_new_tokens=MAX_NEW_TOKENS, **SAMPLING)
    finally:
        model.close()
    return np.asarray(greedy), np.asarray(sampled)


def _hf_greedy(path, input_ids):
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(path, dtype=torch.float32).eval()
    with torch.no_grad():
        return model.generate(torch.from_numpy(input_ids), max_new_tokens=MAX_NEW_TOKENS, do_sample=False).numpy()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def input_ids():
    return np.random.RandomState(11).randint(0, 100, (1, 6)).astype(np.int64)


@pytest.fixture(scope="module")
def jax_swarm_streams(model_path, input_ids, tmp_path_factory):
    """Greedy and sampled streams over two petals_tpu servers on the halves."""
    swarm = Swarm(model_path, ("jax", "jax"), str(tmp_path_factory.mktemp("cache"))).start()
    try:
        return _streams(model_path, swarm.initial_peers, input_ids)
    finally:
        swarm.stop()


@pytest.fixture(scope="module", params=[("jax", "port"), ("port", "jax")], ids=["jax_first", "port_first"])
def mixed_swarm(request, model_path, tmp_path_factory):
    swarm = Swarm(model_path, request.param, str(tmp_path_factory.mktemp("cache"))).start()
    yield swarm
    swarm.stop()


def _read_directory(swarm):
    """The directory as petals_tpu reads it, through a query-only node."""
    uids = [make_uid(default_dht_prefix(swarm.path), i) for i in range(N_LAYERS)]

    async def read():
        reader = await JaxDHTNode.create(initial_peers=swarm.initial_peers, client_mode=True)
        try:
            return await get_remote_module_infos(reader, uids)
        finally:
            await reader.shutdown()

    return swarm.loop.run(read())


def test_port_server_places_itself_on_the_free_half(mixed_swarm):
    port = mixed_swarm.port_server
    want = 0 if mixed_swarm.kinds[0] == "port" else HALF
    assert (port.first_block, port.num_blocks) == (want, HALF)
    assert port.backend.first_block == want


def test_mixed_chain_greedy_stream_equals_jax_swarm_and_hf(mixed_swarm, jax_swarm_streams, model_path, input_ids):
    greedy, _ = _streams(model_path, mixed_swarm.initial_peers, input_ids)
    np.testing.assert_array_equal(greedy, jax_swarm_streams[0])
    np.testing.assert_array_equal(greedy, _hf_greedy(model_path, input_ids))
    # the chain went through the port server: it served sessions
    assert mixed_swarm.port_server.batcher.stats["batched_steps"] > 0


def test_mixed_chain_sampled_stream_equals_jax_swarm(mixed_swarm, jax_swarm_streams, model_path, input_ids):
    _, sampled = _streams(model_path, mixed_swarm.initial_peers, input_ids)
    assert sampled.shape == (1, input_ids.shape[1] + MAX_NEW_TOKENS)
    np.testing.assert_array_equal(sampled, jax_swarm_streams[1])


def test_port_announcement_read_by_petals_tpu(mixed_swarm):
    port = mixed_swarm.port_server
    infos, addr_book = _read_directory(mixed_swarm)
    spans = compute_spans(infos)
    assert sorted((s.start, s.end) for s in spans.values()) == [(0, HALF), (HALF, N_LAYERS)]
    # the two packages' PeerIDs are distinct classes: compare their hex
    mine = {pid.to_string(): span for pid, span in spans.items()}[port.dht.peer_id.to_string()]
    assert (mine.start, mine.end) == (port.first_block, port.first_block + HALF)
    info = mine.server_info
    assert info.state == ServerState.ONLINE
    assert (info.start_block, info.end_block) == (mine.start, mine.end)
    assert info.version == petals_tpu_torch.__version__
    assert info.throughput > 0 and info.forward_rps > 0 and info.inference_rps > 0 and info.network_rps > 0
    assert info.throughput == min(info.forward_rps / HALF, info.network_rps)
    assert (info.quant_type, info.compute_dtype) == ("none", "float32")
    assert info.server_gen is False and info.server_gen_sampling is False
    assert info.cache_tokens_left > 0 and info.pool["lanes"] >= 1
    addrs = {pid.to_string(): addr for pid, addr in addr_book.items()}
    assert addrs[port.dht.peer_id.to_string()].port == port.rpc_server.port


def test_open_ack_echoes_trace_id(mixed_swarm):
    port = mixed_swarm.port_server
    uids = CHAIN_DELIMITER.join(
        make_uid(port.dht_prefix, i) for i in range(port.first_block, port.first_block + HALF)
    )

    async def open_with(trace_id):
        client = await RpcClient.connect("127.0.0.1", port.rpc_server.port)
        try:
            stream = await client.open_stream("ptu.inference")
            await stream.send({"uids": uids, "max_length": 16, "batch_size": 1, "trace_id": trace_id})
            ack = await stream.recv(timeout=60)
            await stream.end()
            return ack
        finally:
            await client.close()

    assert mixed_swarm.loop.run(open_with("trace-abc_123"))["trace_id"] == "trace-abc_123"
    minted = mixed_swarm.loop.run(open_with("not a valid id!"))["trace_id"]
    assert len(minted) == 16 and int(minted, 16) >= 0


def test_port_server_reads_offline_after_shutdown(mixed_swarm):
    """Runs last on its swarm: it takes the port server down."""
    port = mixed_swarm.port_server
    mixed_swarm.loop.run(port.shutdown())
    mixed_swarm.servers.remove(port)
    infos, _ = _read_directory(mixed_swarm)
    me = port.dht.peer_id.to_string()
    for i in range(port.first_block, port.first_block + HALF):
        assert {pid.to_string(): si for pid, si in infos[i].servers.items()}[me].state == ServerState.OFFLINE
    assert me not in {pid.to_string() for pid in compute_spans(infos)}


def test_clis_parse_and_build(model_path):
    from petals_tpu_torch.cli import run_dht, run_server

    args = run_dht.build_parser().parse_args(["--host", "127.0.0.1", "--identity_seed", "boot"])
    loop = Loop()
    try:
        node = loop.run(run_dht.start_node(args))
        try:
            addr = node.own_addr.to_string()
            assert addr.startswith("127.0.0.1:") and addr.endswith(node.peer_id.to_string())
            args = run_server.build_parser().parse_args([
                model_path, "--initial_peers", addr, "--device", "cpu", "--dtype", "float32",
                "--num_blocks", "2", "--update_period", "5",
            ])
            server = run_server.build_server(args)
            assert server.initial_peers == [addr] and server.first_block is None and server.backend is None
            assert (server.num_blocks, server.update_period) == (2, 5.0)
            # --block_indices gives both ends of the span
            args = run_server.build_parser().parse_args(
                [model_path, "--block_indices", "1:3", "--device", "cpu", "--dtype", "float32"]
            )
            assert run_server.parse_block_range(args) == (1, 2)
        finally:
            loop.run(node.shutdown())
    finally:
        loop.close()
