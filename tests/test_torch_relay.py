"""The port's relay circuits and reachability (petals_tpu_torch/rpc/relay.py,
rpc/pool.py's relayed dial, server/reachability.py, Server(relay_via=...)
and run_dht's relay) held to petals_tpu's:

- tests/test_relay.py's four cases on the port alone: the relay address
  form, unary and stream calls through a relay with both identities proven
  end to end, a registration without a valid signature refused, and a
  whole port server behind a port relay (a query-only DHT node, a relayed
  contact address) serving the port's client;
- across the packages: a petals_tpu server behind a PORT relay reached by
  the port's client, and a port server behind a PETALS_TPU relay reached
  by petals_tpu's client; each client's greedy stream through the relay
  equals its stream from the same model served directly;
- ``reach.check`` both ways: a port node checks a petals_tpu node's
  address and the reverse, a wrong peer id reads unreachable, and
  ``check_direct_reachability`` asks both kinds of peers.

Servers run in float32 on the CPU, the per-token path (server-side
generation off), tiny-llama of 4 blocks."""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.dht import DHTNode as JaxDHTNode
from petals_tpu.rpc.relay import RelayServer as JaxRelayServer
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.dht.identity import Identity
from petals_tpu_torch.dht.node import DHTNode
from petals_tpu_torch.dht.routing import PeerAddr
from petals_tpu_torch.rpc.pool import ConnectionPool
from petals_tpu_torch.rpc.relay import RelayRegistrar, RelayServer, relay_dial
from petals_tpu_torch.rpc.server import RpcServer
from petals_tpu_torch.server.server import Server
from tests.test_torch_client import both_clients
from tests.test_torch_swarm import Loop
from tests.utils import make_tiny_llama

N_LAYERS = 4
PROMPT = np.random.RandomState(11).randint(1, 100, (1, 6)).astype(np.int64)
NEW_TOKENS = 6


def test_peer_addr_relay_roundtrip():
    ident = Identity.generate()
    addr = PeerAddr("10.0.0.1", 4321, ident.peer_id, relayed=True)
    assert addr.to_string().startswith("relay+")
    assert PeerAddr.from_string(addr.to_string()) == addr
    assert PeerAddr.from_wire(addr.to_wire()) == addr
    direct = PeerAddr("10.0.0.1", 4321, ident.peer_id)
    assert PeerAddr.from_wire(direct.to_wire()) == direct


def test_relay_reverse_connection_authenticated():
    """Unary and stream calls through the relay to a server with no
    listener; both sides prove their ids through the splice."""

    async def scenario():
        relay = RelayServer()
        await relay.start()
        hidden_identity = Identity.generate()
        hidden = RpcServer(identity=hidden_identity)  # never started: no listener

        async def echo(payload, ctx):
            return {"echo": payload, "from": ctx.remote_peer_id.to_string()}

        async def double(items, ctx):
            async for item in items:
                yield {"doubled": item["x"] * 2}

        hidden.add_unary_handler("test.echo", echo)
        hidden.add_stream_handler("test.double", double)
        registrar = RelayRegistrar(relay.host, relay.port, hidden_identity, hidden)
        await registrar.start()
        await registrar.wait_registered()
        assert relay.is_registered(hidden_identity.peer_id)

        client_identity = Identity.generate()
        pool = ConnectionPool(identity=client_identity)
        client = await pool.get_addr(PeerAddr(relay.host, relay.port, hidden_identity.peer_id, relayed=True))
        reply = await asyncio.wait_for(client.call("test.echo", {"v": 7}), 10)
        assert reply["echo"] == {"v": 7} and reply["from"] == client_identity.peer_id.to_string()
        assert client.remote_peer_id == hidden_identity.peer_id
        stream = await client.open_stream("test.double")
        await stream.send({"x": 21})
        assert await stream.recv(timeout=10) == {"doubled": 42}
        await stream.end()
        with pytest.raises(ConnectionError, match="not registered"):
            await relay_dial(relay.host, relay.port, Identity.generate().peer_id)
        # a pool without an identity refuses a circuit: nothing would be proven
        with pytest.raises(Exception, match="identity"):
            await ConnectionPool().get_addr(PeerAddr(relay.host, relay.port, hidden_identity.peer_id, relayed=True))
        await pool.close()
        await registrar.stop()
        await asyncio.sleep(0)
        for _ in range(200):
            if not relay.is_registered(hidden_identity.peer_id):
                break
            await asyncio.sleep(0.01)
        assert not relay.is_registered(hidden_identity.peer_id)  # the control channel dropped
        await relay.stop()

    asyncio.run(asyncio.wait_for(scenario(), 60))


def test_relay_register_requires_proof():
    async def scenario():
        from petals_tpu_torch.rpc.protocol import read_frame, write_frame

        relay = RelayServer()
        await relay.start()
        reader, writer = await asyncio.open_connection(relay.host, relay.port)
        lock = asyncio.Lock()
        await read_frame(reader)
        ident = Identity.generate()
        await write_frame(writer, {"t": "relay_register", "pub": ident.public_bytes.hex(), "sig": "00" * 64}, lock)
        reply = await asyncio.wait_for(read_frame(reader), 10)
        assert reply["t"] == "relay_err" and not relay.is_registered(ident.peer_id)
        writer.close()
        await relay.stop()

    asyncio.run(asyncio.wait_for(scenario(), 30))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


class _Swarm:
    """A bootstrap DHT node ("port" or "jax"), a relay ("port" or "jax")
    and one whole-model server ("port" or "jax"), hidden behind the relay
    or reached directly, on a loop thread of their own."""

    def __init__(self, path, bootstrap, relay, server, hidden):
        self.loop = Loop()
        self.path = path

        async def boot():
            if bootstrap == "port":
                self.bootstrap = await DHTNode.create()
            else:
                self.bootstrap = await JaxDHTNode.create(maintenance_period=1000)
            self.relay = RelayServer() if relay == "port" else JaxRelayServer()
            await self.relay.start()
            via = f"{self.relay.host}:{self.relay.port}" if hidden else None
            if server == "port":
                self.server = Server(
                    path, first_block=0, num_blocks=N_LAYERS, initial_peers=[self.bootstrap.own_addr.to_string()],
                    device="cpu", compute_dtype=torch.float32, throughput=1.0, relay_via=via,
                    server_side_generation=False,
                )
            else:
                self.server = JaxServer(
                    path, first_block=0, num_blocks=N_LAYERS, initial_peers=[self.bootstrap.own_addr.to_string()],
                    compute_dtype=jnp.float32, use_flash=False, throughput=1.0, relay_via=via,
                    server_side_generation=False,
                )
            await self.server.start()

        self.loop.run(boot())

    @property
    def initial_peers(self):
        return [self.bootstrap.own_addr.to_string()]

    def greedy(self, which):
        """The greedy stream of ``which`` client ("port" or "jax")."""
        jax_model, port_model = both_clients(self.path, self.initial_peers)
        try:
            model = port_model if which == "port" else jax_model
            ids = PROMPT if which == "jax" else torch.from_numpy(PROMPT)
            return np.asarray(model.generate(ids, max_new_tokens=NEW_TOKENS))
        finally:
            port_model.close()
            jax_model.close()

    def stop(self):
        async def teardown():
            await self.server.shutdown()
            await self.relay.stop()
            await self.bootstrap.shutdown()

        self.loop.run(teardown())
        self.loop.close()


def _stream(path, client, **swarm):
    s = _Swarm(path, **swarm)
    try:
        if swarm["hidden"]:
            assert s.server.dht.client_mode  # no DHT listener either
            assert s.server.contact_addr.relayed
        return s.greedy(client)
    finally:
        s.stop()


@pytest.mark.parametrize("client,bootstrap,relay,server", [
    ("port", "port", "port", "port"),  # the port alone (tests/test_relay.py's e2e case)
    ("port", "jax", "port", "jax"),  # a petals_tpu hidden server, a port relay, the port's client
    ("jax", "jax", "jax", "port"),  # a port hidden server, a petals_tpu relay, petals_tpu's client
])
def test_hidden_server_stream_equals_direct(model_path, client, bootstrap, relay, server):
    via_relay = _stream(model_path, client, bootstrap=bootstrap, relay=relay, server=server, hidden=True)
    direct = _stream(model_path, client, bootstrap=bootstrap, relay=relay, server=server, hidden=False)
    assert via_relay.shape == (1, PROMPT.shape[1] + NEW_TOKENS)
    np.testing.assert_array_equal(via_relay, direct)


def test_reach_check_both_ways():
    """A port node's ``reach.check`` dials a petals_tpu node's address back
    and the reverse; a wrong peer id reads unreachable; both nodes' run_dht
    setups register it; ``check_direct_reachability`` asks both kinds."""
    from petals_tpu.server.reachability import ReachabilityProtocol as JaxReach
    from petals_tpu.server.reachability import check_direct_reachability as jax_check
    from petals_tpu_torch.server.reachability import ReachabilityProtocol, check_direct_reachability

    async def scenario():
        port_node = await DHTNode.create()
        ReachabilityProtocol().register(port_node.server)
        jax_node = await JaxDHTNode.create(maintenance_period=1000, initial_peers=[port_node.own_addr.to_string()])
        JaxReach().register(jax_node.server)
        third = await DHTNode.create(initial_peers=[port_node.own_addr.to_string()])
        ReachabilityProtocol().register(third.server)
        try:
            port_client = await port_node.pool.get(port_node.own_addr.host, port_node.own_addr.port)
            jax_client = await jax_node.pool.get(jax_node.own_addr.host, jax_node.own_addr.port)
            assert (await port_client.call("reach.check", {"addr": jax_node.own_addr.to_string()}))["reachable"]
            assert (await jax_client.call("reach.check", {"addr": port_node.own_addr.to_string()}))["reachable"]
            wrong = f"{jax_node.own_addr.host}:{jax_node.own_addr.port}/{Identity.generate().peer_id.to_string()}"
            assert not (await port_client.call("reach.check", {"addr": wrong}))["reachable"]
            assert await check_direct_reachability(third) is True  # asks the port node (and the JAX one)
            assert await jax_check(jax_node) is True
        finally:
            for node in (third, jax_node, port_node):
                await node.shutdown()

    asyncio.run(asyncio.wait_for(scenario(), 60))


def test_run_dht_runs_a_relay_by_default():
    from petals_tpu_torch.cli.run_dht import build_parser, start_node, start_relay

    args = build_parser().parse_args(["--host", "127.0.0.1"])
    assert not args.no_relay and args.relay_port == 0
    assert build_parser().parse_args(["--no_relay"]).no_relay

    async def scenario():
        node = await start_node(args)
        relay = await start_relay(args, node)
        try:
            client = await node.pool.get(node.own_addr.host, node.own_addr.port)
            info = await client.call("relay.info", {})
            assert info == {"host": "127.0.0.1", "port": relay.port}
            assert "reach.check" in node.server._unary
        finally:
            await relay.stop()
            await node.shutdown()

    asyncio.run(asyncio.wait_for(scenario(), 30))
