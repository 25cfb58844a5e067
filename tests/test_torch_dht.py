"""The port's DHT against petals_tpu's, on loopback:

- one swarm of petals_tpu and port nodes: a port store is read by a
  petals_tpu ``get`` and a petals_tpu store by a port ``get`` (plain and
  signed subkey records, merged across writers);
- port storers refuse an unsigned or wrongly signed subkey record, sent by
  a petals_tpu client over the wire or stored through a port node;
- ``RoutingTable`` (add / remove / get / nearest, with bucket eviction),
  ``bucket_index`` and ``DHTStorage`` (subkey merge, expiry, eviction) give
  the petals_tpu classes' answers on seeded random sequences of operations,
  on one fake clock;
- the identity handshake works both ways: a petals_tpu RpcClient with an
  identity learns the port server's proven id and the port server its,
  a port client learns a petals_tpu server's, an unproven claim is never
  trusted, and a forged proof is refused (the connection closes, or the id
  stays unproven);
- ServerInfo's wire tuple and its msgpack bytes equal petals_tpu's, with
  the same forward-compatible reading; the directory (module announcements,
  spans, the address book) and the model registry cross both ways; the
  ping aggregator smooths RTTs as petals_tpu's does.

Every wait is bounded by asyncio.wait_for or a call timeout."""

import asyncio
import dataclasses
import math
import time

import msgpack
import numpy as np
import pytest

from petals_tpu.data_structures import PeerID as JaxPeerID
from petals_tpu.dht import DHTNode as JaxDHTNode
from petals_tpu.dht import identity as jax_ident
from petals_tpu.dht import routing as jax_routing
from petals_tpu.dht import storage as jax_storage
from petals_tpu.rpc import RpcClient as JaxRpcClient
from petals_tpu.rpc.server import RpcServer as JaxRpcServer
from petals_tpu_torch.data_structures import PeerID
from petals_tpu_torch.dht import DHTNode
from petals_tpu_torch.dht import identity as port_ident
from petals_tpu_torch.dht import routing as port_routing
from petals_tpu_torch.dht import storage as port_storage
from petals_tpu_torch.rpc import RpcClient, RpcServer
from petals_tpu_torch.rpc.protocol import read_frame, write_frame

pytestmark = pytest.mark.timeout(120)
TIMEOUT = 60


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, TIMEOUT))


async def _mixed_swarm():
    """A petals_tpu bootstrap, then port, petals_tpu, port, petals_tpu nodes."""
    boot = await JaxDHTNode.create(maintenance_period=1000)
    peers = [boot.own_addr.to_string()]
    nodes = [boot]
    for kind in ("port", "jax", "port", "jax"):
        cls = DHTNode if kind == "port" else JaxDHTNode
        nodes.append(await cls.create(initial_peers=peers, maintenance_period=1000))
    return nodes


async def _shutdown(nodes):
    for node in nodes:
        await node.shutdown()


def _is_port(node):
    return isinstance(node, DHTNode)


@pytest.mark.parametrize("writer_kind", ["port", "jax"])
def test_records_cross_between_the_packages(writer_kind):
    async def main():
        nodes = await _mixed_swarm()
        try:
            writers = [n for n in nodes[1:] if _is_port(n) == (writer_kind == "port")]
            readers = [n for n in nodes if _is_port(n) != (writer_kind == "port")]
            exp = time.time() + 30
            assert await writers[0].store(f"plain-{writer_kind}", {"v": [1, 2.5, "x"]}, exp)
            for w in writers:  # two writers' signed announcements under one key
                ident = port_ident if _is_port(w) else jax_ident
                rec = ident.sign_announcement(w.identity, "blocks.0", {"who": w.peer_id.to_string()}, exp)
                assert await w.store("blocks.0", rec, exp, subkey=w.peer_id.to_string())
            for reader in readers:
                value, got_exp = await reader.get(f"plain-{writer_kind}")
                assert value == {"v": [1, 2.5, "x"]} and got_exp == exp
                subkeys, _ = await reader.get("blocks.0")
                assert sorted(subkeys) == sorted(w.peer_id.to_string() for w in writers)
                for sk, (rec, e) in subkeys.items():
                    assert rec["payload"] == {"who": sk}
                    assert jax_ident.verify_announcement(rec, sk, e) and port_ident.verify_announcement(rec, sk, e)
        finally:
            await _shutdown(nodes)

    run(main())


def test_port_storers_refuse_unsigned_or_wrongly_signed_subkey_records():
    async def main():
        storer = await DHTNode.create(maintenance_period=1000)
        victim = jax_ident.Identity.from_seed(b"victim")
        attacker = jax_ident.Identity.from_seed(b"attacker")
        sk = victim.peer_id.to_string()
        exp = time.time() + 30
        key = "blocks.7"
        kid = port_storage_key(key)
        client = await JaxRpcClient.connect("127.0.0.1", storer.server.port, identity=attacker)
        try:
            entries = [
                [kid.hex(), sk, {"fake": True}, exp],  # unsigned
                [kid.hex(), sk, jax_ident.sign_announcement(attacker, key, {"fake": 2}, exp), exp],  # wrong key
                [kid.hex(), sk, jax_ident.sign_announcement(victim, key, {"real": 1}, exp), exp + 5],  # wrong expiry
            ]
            reply = await client.call("dht.store", {"entries": entries, "sender": None}, timeout=10)
            assert reply["ok"] == [False, False, False]
            assert storer.storage.get(kid) is None
            # a port node storing an unsigned record under a subkey refuses it too
            assert not await storer.store(key, {"fake": 3}, exp, subkey=sk)
            assert storer.storage.get(kid) is None
            good = jax_ident.sign_announcement(victim, key, {"real": 1}, exp)
            reply = await client.call("dht.store", {"entries": [[kid.hex(), sk, good, exp]], "sender": None}, timeout=10)
            assert reply["ok"] == [True]
            subkeys, _ = storer.storage.get(kid)
            assert list(subkeys) == [sk] and subkeys[sk][0]["payload"] == {"real": 1}
        finally:
            await client.close()
            await storer.shutdown()

    run(main())


def port_storage_key(key: str) -> bytes:
    from petals_tpu_torch.dht.node import key_id

    return key_id(key)


class _Clock:
    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        self.t += 1e-3
        return self.t


def _ids(rng, n):
    return [bytes(rng.randint(0, 256, 32).astype(np.uint8)) for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_routing_table_and_buckets_equal_petals_tpu(seed, monkeypatch):
    clock = _Clock(100.0)
    monkeypatch.setattr(jax_routing, "time", clock)
    monkeypatch.setattr(port_routing, "time", clock)
    rng = np.random.RandomState(seed)
    own, *others = _ids(rng, 120)
    # ids sharing the owner's top byte land in low buckets; the rest crowd
    # bucket 255, which the small bucket size then makes evict
    jt = jax_routing.RoutingTable(JaxPeerID(own), bucket_size=4)
    pt = port_routing.RoutingTable(PeerID(own), bucket_size=4)
    for step in range(400):
        raw = others[rng.randint(len(others))]
        op = rng.choice(["add", "add", "add", "remove", "get", "nearest"])
        if op == "add":
            port_no = int(rng.randint(1, 65535))
            jt.add(jax_routing.PeerAddr("127.0.0.1", port_no, JaxPeerID(raw)))
            pt.add(port_routing.PeerAddr("127.0.0.1", port_no, PeerID(raw)))
        elif op == "remove":
            jt.remove(JaxPeerID(raw))
            pt.remove(PeerID(raw))
        elif op == "get":
            a, b = jt.get(JaxPeerID(raw)), pt.get(PeerID(raw))
            assert (a is None) == (b is None) and (a is None or a.to_wire() == b.to_wire())
        else:
            k = int(rng.randint(1, 12))
            assert [a.to_wire() for a in jt.nearest(JaxPeerID(raw), k)] == [
                a.to_wire() for a in pt.nearest(PeerID(raw), k)
            ]
        assert len(jt) == len(pt)
        assert jax_routing.bucket_index(JaxPeerID(own), JaxPeerID(raw)) == port_routing.bucket_index(
            PeerID(own), PeerID(raw)
        )
    assert sorted(a.to_string() for a in jt.all_peers()) == sorted(a.to_string() for a in pt.all_peers())
    for addr in pt.all_peers():  # the wire and textual forms round-trip alike
        assert jax_routing.PeerAddr.from_wire(addr.to_wire()).to_string() == addr.to_string()
        assert port_routing.PeerAddr.from_string(addr.to_string()) == addr


@pytest.mark.parametrize("seed", range(3))
def test_storage_equals_petals_tpu(seed, monkeypatch):
    clock = _Clock(1000.0)
    monkeypatch.setattr(jax_storage, "time", clock)
    monkeypatch.setattr(port_storage, "time", clock)
    rng = np.random.RandomState(seed)
    keys = [bytes([k]) * 4 for k in range(6)]
    subkeys = [None, "a", "b", "c"]
    js, ps = jax_storage.DHTStorage(maxsize=4), port_storage.DHTStorage(maxsize=4)
    for step in range(500):
        op = rng.choice(["store", "store", "get", "tick", "expire"])
        key = keys[rng.randint(len(keys))]
        if op == "store":
            sk = subkeys[rng.randint(len(subkeys))]
            exp = clock.t + float(rng.uniform(-2, 20))
            value = {"step": step}
            assert js.store(key, value, exp, sk) == ps.store(key, value, exp, sk), step
        elif op == "get":
            a, b = js.get(key), ps.get(key)
            assert (a is None) == (b is None), step
            if a is not None:
                assert isinstance(a[0], jax_storage.SubkeyDict) == isinstance(b[0], port_storage.SubkeyDict)
                assert dict(a[0]) == dict(b[0]) if isinstance(a[0], dict) else a[0] == b[0]
                assert a[1] == b[1]
        elif op == "tick":
            clock.t += float(rng.uniform(0, 4))
        else:
            js.remove_expired()
            ps.remove_expired()
        assert len(js) == len(ps), step
        assert js._records.keys() == ps._records.keys(), step


async def _check_handshake(server_cls, client_cls, server_ident, client_ident):
    seen = {}

    async def who(payload, ctx):
        seen["remote"] = ctx.remote_peer_id
        return {"ok": True}

    server = server_cls(identity=server_ident)
    server.add_unary_handler("who", who)
    await server.start()
    try:
        client = await client_cls.connect("127.0.0.1", server.port, identity=client_ident)
        try:
            assert (await client.call("who", {}, timeout=10))["ok"]
            proven = await client.wait_authenticated(10)
            assert proven.to_string() == server_ident.peer_id.to_string()
            assert seen["remote"].to_string() == client_ident.peer_id.to_string()
        finally:
            await client.close()
        # an id claimed without a key proves nothing
        claimer = await JaxRpcClient.connect("127.0.0.1", server.port, peer_id=JaxPeerID.generate())
        try:
            await claimer.call("who", {}, timeout=10)
            assert seen["remote"] is None
        finally:
            await claimer.close()
    finally:
        await server.stop()


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server", "port_both"])
def test_identity_handshake_both_ways(direction):
    server_cls = JaxRpcServer if direction == "port_client_jax_server" else RpcServer
    client_cls = JaxRpcClient if direction == "jax_client_port_server" else RpcClient
    server_ident = (jax_ident if server_cls is JaxRpcServer else port_ident).Identity.from_seed(b"server")
    client_ident = (jax_ident if client_cls is JaxRpcClient else port_ident).Identity.from_seed(b"client")
    run(_check_handshake(server_cls, client_cls, server_ident, client_ident))


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_forged_client_proof_closes_the_connection(server_kind):
    """A client whose auth frame is not its key's signature over the
    server's nonce is dropped, whichever package serves."""

    async def main():
        if server_kind == "port":
            server = RpcServer(identity=port_ident.Identity.from_seed(b"server"))
        else:
            server = JaxRpcServer(identity=jax_ident.Identity.from_seed(b"server"))
        server.add_unary_handler("who", _ok)
        await server.start()
        client_cls, ident = (JaxRpcClient, jax_ident) if server_kind == "port" else (RpcClient, port_ident)
        try:
            client = await client_cls.connect("127.0.0.1", server.port, identity=ident.Identity.from_seed(b"honest"))
            await asyncio.sleep(0.1)  # the honest proof went first; now forge one
            await client._send({"t": "auth", "sig": "00" * 64})
            with pytest.raises(Exception):
                await client.call("who", {}, timeout=5)
            try:
                await client.close()
            except Exception:
                pass
        finally:
            await server.stop()

    run(main())


def test_port_client_refuses_a_forged_server_proof():
    """A server that claims a key but signs with another leaves the port
    client's remote id unproven."""
    claimed = jax_ident.Identity.from_seed(b"claimed")
    impostor = jax_ident.Identity.from_seed(b"impostor")
    me = port_ident.Identity.from_seed(b"me")

    async def fake_server(reader, writer):
        lock = asyncio.Lock()
        await write_frame(writer, {"t": "hello", "peer_id": claimed.peer_id.to_string(),
                                   "pub": claimed.public_bytes.hex(), "nonce": "00" * 16}, lock)
        hello = await read_frame(reader)
        message = jax_ident.hello_challenge_message(
            claimed.public_bytes, bytes.fromhex(hello["pub"]), bytes.fromhex(hello["nonce"])
        )
        await write_frame(writer, {"t": "auth", "sig": impostor.sign(message).hex()}, lock)
        try:
            while True:
                await read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            writer.close()

    async def main():
        server = await asyncio.start_server(fake_server, "127.0.0.1", 0)
        try:
            client = await RpcClient.connect("127.0.0.1", server.sockets[0].getsockname()[1], identity=me)
            assert await client.wait_authenticated(10) is None
            assert client.remote_peer_id is None
            await client.close()
        finally:
            server.close()
            await server.wait_closed()

    run(main())


async def _ok(payload=None, ctx=None):
    return {"ok": True}


def _full_server_info(mod):
    return mod.ServerInfo(
        state=mod.ServerState.ONLINE, throughput=123.5, start_block=2, end_block=4, public_name="n",
        version="0.1.0", network_rps=1e4, forward_rps=5e5, inference_rps=500.0, adapters=("a",),
        compute_dtype="bfloat16", quant_type="nf4a", using_relay=False, cache_tokens_left=8192,
        next_pings={"ab": 0.001}, server_gen=False, server_gen_sampling=False, spec_k=None,
        pool={"lanes": 4, "busy_lanes": 1}, telemetry=None, compile_stats=None, integrity=None,
        metrics_port=None, phase_tier=None,
    )


def test_server_info_wire_equals_petals_tpu():
    from petals_tpu import data_structures as jds
    from petals_tpu_torch import data_structures as pds
    from petals_tpu_torch.rpc.msgpack_codec import packb, unpackb

    assert [f.name for f in dataclasses.fields(pds.ServerInfo)] == [f.name for f in dataclasses.fields(jds.ServerInfo)]
    port_wire, jax_wire = pds.server_info_to_wire(_full_server_info(pds)), jds.server_info_to_wire(_full_server_info(jds))
    assert port_wire == jax_wire
    assert packb(port_wire) == msgpack.packb(jax_wire, use_bin_type=True)  # the same bytes on the wire
    # a newer peer's unknown field is dropped, a malformed next_pings cleaned
    wire = list(jax_wire)
    wire[2] = dict(wire[2], brand_new_field=1, next_pings={"ok": 0.5, "bad": "x", 3: 1.0, "inf": float("inf")})
    got, want = pds.server_info_from_wire(unpackb(packb(wire))), jds.server_info_from_wire(wire)
    assert got.to_tuple() == want.to_tuple()
    assert got.next_pings == {"ok": 0.5} and got.state == pds.ServerState.ONLINE
    wire[2]["next_pings"] = "garbage"
    assert pds.server_info_from_wire(wire).next_pings is None is jds.server_info_from_wire(wire).next_pings
    with pytest.raises(ValueError):
        pds.ServerInfo.from_tuple((2,))


def test_directory_and_model_registry_cross_between_the_packages():
    from petals_tpu import data_structures as jds
    from petals_tpu.utils import dht_utils as jax_dir
    from petals_tpu_torch import data_structures as pds
    from petals_tpu_torch.utils import dht_utils as port_dir

    async def main():
        nodes = await _mixed_swarm()
        try:
            port_node, jax_node = nodes[1], nodes[2]
            exp = time.time() + 30
            uids = port_dir.module_uids("m", range(2))
            assert uids == jax_dir.module_uids("m", range(2)) == ["m.0", "m.1"]
            assert await port_dir.declare_active_modules(port_node, uids, _full_server_info(pds), exp) == 2
            assert await port_dir.declare_model(port_node, "m", num_blocks=4, expiration_time=exp, model_type="llama")
            assert await jax_dir.declare_active_modules(jax_node, ["m.1"], _full_server_info(jds), exp) == 1
            assert await jax_dir.declare_model(jax_node, "m", num_blocks=4, expiration_time=exp, public_name="j")
            for reader, mod in ((nodes[4], jax_dir), (nodes[3], port_dir)):
                infos, addr_book = await mod.get_remote_module_infos(reader, uids)
                assert sorted(p.to_string() for p in infos[1].servers) == sorted(
                    n.peer_id.to_string() for n in (port_node, jax_node))
                assert [p.to_string() for p in infos[0].servers] == [port_node.peer_id.to_string()]
                spans = mod.compute_spans(infos)
                assert sorted((s.start, s.end) for s in spans.values()) == [(0, 2), (1, 2)]
                assert {p.to_string(): a.port for p, a in addr_book.items()} == {
                    port_node.peer_id.to_string(): port_node.server.port, jax_node.peer_id.to_string(): jax_node.server.port}
                models = await mod.list_models(reader)
                assert models["m"]["num_blocks"] == 4 and sorted(models["m"]["peers"]) == sorted(
                    n.peer_id.to_string() for n in (port_node, jax_node))
            directory = port_dir.ModuleDirectory(nodes[3])
            infos = await directory.fetch(uids)
            assert directory.addr_of(port_node.peer_id).port == port_node.server.port and infos[0] is not None
            assert port_dir.default_expiration(2.0) - time.time() == pytest.approx(60.0, abs=1.0)
        finally:
            await _shutdown(nodes)

    run(main())


def test_ping_smoothing_equals_petals_tpu():
    from petals_tpu.rpc.pool import ConnectionPool as JaxPool
    from petals_tpu.utils.ping import PingAggregator as JaxPings
    from petals_tpu_torch.rpc.pool import ConnectionPool
    from petals_tpu_torch.utils.ping import PingAggregator

    jp, pp = JaxPings(JaxPool()), PingAggregator(ConnectionPool())
    rng = np.random.RandomState(0)
    raws = [bytes([i]) * 32 for i in range(3)]
    for step in range(40):
        raw = raws[rng.randint(3)]
        rtt = math.inf if rng.rand() < 0.1 else float(rng.uniform(1e-4, 1e-2))
        jp._update(JaxPeerID(raw), rtt, 1000.0 + step)
        pp._update(PeerID(raw), rtt, 1000.0 + step)
    # both keep (rtt, jitter, expiry), and estimate the same jitter
    assert {k.to_string(): v for k, v in jp._rtts.items()} == {
        k.to_string(): v for k, v in pp._rtts.items()
    }
    assert pp.noise_s() == jp.noise_s()
