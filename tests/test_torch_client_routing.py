"""The port's RemoteSequenceManager against petals_tpu's, on the same
synthetic swarm: petals_tpu DHT nodes announce spans, throughputs and
next_pings (built as tests/test_sequence_manager.py builds them), and a
manager of each package, on the same rtts, must build the same chains
(peer, start, end): both modes (max_throughput with Python's ``random``
seeded alike), bans and unbans, allow and block lists, congestion blame,
prefix affinity, next_pings, and MissingBlocksError. The ping jitter
estimate (``noise_s``) and the affinity amplitude equal petals_tpu's."""

import asyncio
import random
import time

import numpy as np
import pytest

from petals_tpu.client.config import ClientConfig as JaxConfig
from petals_tpu.client.routing.sequence_manager import MissingBlocksError as JaxMissing
from petals_tpu.client.routing.sequence_manager import RemoteSequenceManager as JaxManager
from petals_tpu.data_structures import ServerInfo, ServerState, make_uid
from petals_tpu.dht import DHTNode
from petals_tpu.utils.dht_utils import declare_active_modules
from petals_tpu_torch.client import ClientConfig
from petals_tpu_torch.client.routing import MissingBlocksError, RemoteSequenceManager

pytestmark = pytest.mark.timeout(120)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 90))


async def _swarm(n_blocks, specs):
    """specs: (start, end, throughput[, next_pings by spec index]). Returns
    (bootstrap, nodes, uids)."""
    boot = await DHTNode.create(maintenance_period=1000)
    uids = [make_uid("m", i) for i in range(n_blocks)]
    nodes = [await DHTNode.create(initial_peers=[boot.own_addr], maintenance_period=1000) for _ in specs]
    for node, spec in zip(nodes, specs):
        start, end, throughput = spec[:3]
        pings = {nodes[j].peer_id.to_string(): rtt for j, rtt in (spec[3] if len(spec) > 3 else {}).items()}
        info = ServerInfo(ServerState.ONLINE, throughput, start_block=start, end_block=end,
                          inference_rps=throughput, next_pings=pings or None)
        await declare_active_modules(node, uids[start:end], info, time.time() + 60)
    return boot, nodes, uids


def _hex_rtt(table, default=0.001):
    """An rtt_fn over peer ids of either package, keyed by hex strings."""
    return lambda src, dst: table.get((src.to_string() if src is not None else None, dst.to_string()), default)


class Pair:
    """A petals_tpu manager and a port manager over the same swarm."""

    def __init__(self, jax_mgr, port_mgr):
        self.jax, self.port = jax_mgr, port_mgr

    @classmethod
    async def create(cls, boot, uids, rtt=None, **config):
        peers = [boot.own_addr.to_string()]
        kw = {} if rtt is None else {"rtt_fn": rtt}
        jax_mgr = await JaxManager.create(JaxConfig(initial_peers=peers, update_period=1000, **config), uids, **kw)
        port_mgr = await RemoteSequenceManager.create(ClientConfig(initial_peers=peers, update_period=1000, **config), uids, **kw)
        for mgr in (jax_mgr, port_mgr):
            await mgr.ensure_ready()
            # the update loop's first refresh queues behind ensure_ready's on
            # the lock; one more update runs after it, so the loop sleeps now
            await mgr.update()
        return cls(jax_mgr, port_mgr)

    async def chains(self, *args, seed=None, **kwargs):
        """Both managers' chains as [(peer hex, start, end)]; with ``seed``,
        Python's random is seeded alike before each."""
        out = []
        for mgr in (self.jax, self.port):
            if seed is not None:
                random.seed(seed)
            chain = await mgr.make_sequence(*args, **kwargs)
            out.append([(s.peer_id.to_string(), s.start, s.end) for s in chain])
        assert out[0] == out[1], out
        return out[1]

    def both(self, method, peer_hex, *args):
        """Call ``method`` on each manager with its own package's PeerID."""
        from petals_tpu.data_structures import PeerID as JaxPeerID
        from petals_tpu_torch.data_structures import PeerID

        getattr(self.jax, method)(JaxPeerID.from_string(peer_hex), *args)
        getattr(self.port, method)(PeerID.from_string(peer_hex), *args)

    async def shutdown(self):
        await self.jax.shutdown()
        await self.port.shutdown()


async def _teardown(pair, boot, nodes):
    if pair is not None:
        await pair.shutdown()
    for node in nodes + [boot]:
        await node.shutdown()


def test_both_modes_give_the_same_chains():
    async def main():
        boot, nodes, uids = await _swarm(6, [(0, 3, 10.0), (3, 6, 8.0), (0, 6, 5.0), (2, 5, 20.0)])
        pair = None
        try:
            pair = await Pair.create(boot, uids, rtt=_hex_rtt({}))
            chain = await pair.chains(mode="min_latency")
            assert chain[0][1] == 0 and chain[-1][2] == 6
            for seed in range(6):
                await pair.chains(mode="max_throughput", seed=seed)
                await pair.chains(2, 5, mode="max_throughput", seed=seed)
            await pair.chains(1, 4, mode="min_latency", cache_tokens_needed=100)
        finally:
            await _teardown(pair, boot, nodes)

    run(main())


def test_fast_servers_fewer_hops_and_inter_server_rtts():
    async def main():
        boot, nodes, uids = await _swarm(4, [(0, 2, 10.0), (2, 4, 10.0), (2, 4, 10.0), (0, 4, 2.0)])
        a, b, c, _ = (n.peer_id.to_string() for n in nodes)
        table = {(a, b): 0.5}
        pair = None
        try:
            pair = await Pair.create(boot, uids, rtt=_hex_rtt(table))
            chain = await pair.chains(mode="min_latency")
            assert [p for p, _, _ in chain] == [a, c]
            table.clear()
            table[(a, c)] = 0.5  # the slow link moves: so does the route
            chain = await pair.chains(mode="min_latency")
            assert [p for p, _, _ in chain] == [a, b]
        finally:
            await _teardown(pair, boot, nodes)

    run(main())


def test_bans_unbans_and_congestion():
    async def main():
        boot, nodes, uids = await _swarm(2, [(0, 2, 100.0), (0, 2, 1.0)])
        fast, slow = (n.peer_id.to_string() for n in nodes)
        pair = None
        try:
            pair = await Pair.create(boot, uids, rtt=_hex_rtt({}), ban_timeout=0.3)
            assert (await pair.chains(mode="min_latency"))[0][0] == fast
            pair.both("on_request_failure", fast)
            assert (await pair.chains(mode="min_latency"))[0][0] == slow
            await asyncio.sleep(0.5)  # the ban (at most 1.25 x 0.3 s) expires
            assert (await pair.chains(mode="min_latency"))[0][0] == fast
            pair.both("on_request_success", fast)
            assert fast not in {p.to_string() for p in pair.port._banned}
            # congestion blame: a soft penalty that flips a near-tie
            near = await Pair.create(boot, uids, rtt=_hex_rtt({}))
            try:
                for mgr in (near.jax, near.port):
                    for span in mgr.state.spans_by_priority:
                        span.server_info.inference_rps = 1000.0  # equal decode cost
                first = (await near.chains(mode="min_latency"))[0][0]
                near.both("report_congestion", first, 1.0)
                assert (await near.chains(mode="min_latency"))[0][0] != first
            finally:
                await near.shutdown()
        finally:
            await _teardown(pair, boot, nodes)

    run(main())


def test_allow_and_block_lists():
    async def main():
        boot, nodes, uids = await _swarm(2, [(0, 2, 100.0), (0, 2, 1.0), (0, 2, 50.0)])
        fast, slow, mid = (n.peer_id.to_string() for n in nodes)
        pairs = []
        try:
            pairs.append(await Pair.create(boot, uids, rtt=_hex_rtt({}), allowed_servers=[slow]))
            assert {p for p, _, _ in await pairs[-1].chains(mode="min_latency")} == {slow}
            pairs.append(await Pair.create(boot, uids, rtt=_hex_rtt({}), blocked_servers=[fast]))
            assert (await pairs[-1].chains(mode="min_latency"))[0][0] == mid
        finally:
            for pair in pairs:
                await pair.shutdown()
            await _teardown(None, boot, nodes)

    run(main())


def test_prefix_affinity_picks_the_same_replica():
    async def main():
        boot, nodes, uids = await _swarm(2, [(0, 2, 10.0), (0, 2, 10.0)])
        pair = None
        try:
            pair = await Pair.create(boot, uids, rtt=_hex_rtt({}))
            picks = set()
            for seed in range(16):
                picks.add((await pair.chains(mode="min_latency", affinity_seed=seed))[0][0])
            assert len(picks) == 2  # seeds spread over both replicas, alike in both packages
        finally:
            await _teardown(pair, boot, nodes)

    run(main())


def test_published_next_pings_drive_default_routing():
    """No rtt_fn: server->server edges come from the source's next_pings."""

    async def main():
        # a serves [0, 2) and announces a slow link to b, a fast one to c
        boot, nodes, uids = await _swarm(4, [(0, 2, 10.0, {1: 0.5, 2: 0.0001}), (2, 4, 10.0), (2, 4, 10.0)])
        a, b, c = (n.peer_id.to_string() for n in nodes)
        pair = None
        try:
            pair = await Pair.create(boot, uids)
            assert [p for p, _, _ in await pair.chains(mode="min_latency")] == [a, c]
        finally:
            await _teardown(pair, boot, nodes)

    run(main())


def test_missing_blocks_raise_in_both():
    async def main():
        boot, nodes, uids = await _swarm(4, [(0, 2, 1.0)])  # blocks 2 and 3 unserved
        pair = None
        try:
            pair = await Pair.create(boot, uids, rtt=_hex_rtt({}))
            with pytest.raises(JaxMissing):
                await pair.jax.make_sequence(mode="max_throughput")
            with pytest.raises(MissingBlocksError, match=r"\[2, 3\]"):
                await pair.port.make_sequence(mode="max_throughput")
            assert await pair.chains(0, 2, mode="min_latency")
        finally:
            await _teardown(pair, boot, nodes)

    run(main())


def test_ping_noise_estimate_and_affinity_amplitude_equal_petals_tpu():
    from petals_tpu.client.routing.sequence_manager import affinity_amplitude as jax_amplitude
    from petals_tpu.data_structures import PeerID as JaxPeerID
    from petals_tpu.utils.ping import PingAggregator as JaxPings
    from petals_tpu_torch.client.routing.sequence_manager import affinity_amplitude
    from petals_tpu_torch.data_structures import PeerID
    from petals_tpu_torch.utils.ping import PingAggregator

    jp, pp = JaxPings(pool=None), PingAggregator(pool=None)
    rng = np.random.RandomState(0)
    now = time.monotonic()
    for step in range(300):
        for i in range(4):
            rtt = 0.02 + float(rng.randn()) * 2e-3
            jp._update(JaxPeerID(bytes([i]) * 32), rtt, now + step * 1e-3)
            pp._update(PeerID(bytes([i]) * 32), rtt, now + step * 1e-3)
    assert pp.noise_s() == jp.noise_s() > 0
    assert pp.rtt(PeerID(bytes([1]) * 32)) == jp.rtt(JaxPeerID(bytes([1]) * 32))
    assert pp.rtt(PeerID(bytes([9]) * 32), 0.5) == 0.5
    for noise in (0.0, pp.noise_s(), 1e-4, 1.0):
        assert affinity_amplitude(noise) == jax_amplitude(noise)


def test_open_wait_piggyback_blames_and_refreshes():
    """A lane-admission wait in the session-open ack that dominates the open
    blames the peer and asks for a routing refresh at once (as
    tests/test_sequence_manager.py holds petals_tpu's); the open message
    carries alloc_timeout, client_version and trace_id."""
    import petals_tpu_torch
    from petals_tpu_torch.client.inference_session import _ServerInferenceSession
    from petals_tpu_torch.data_structures import PeerID, RemoteSpanInfo
    from petals_tpu_torch.data_structures import ServerInfo as PortServerInfo
    from petals_tpu_torch.data_structures import ServerState as PortState

    class FakeStream:
        def __init__(self, ack):
            self.sent, self._ack = [], ack

        async def send(self, msg):
            self.sent.append(msg)

        async def recv(self, timeout=None):
            return self._ack

    class FakeStub:
        def __init__(self, stream):
            self._stream = stream

        async def open_stream(self, route):
            return self._stream

    class FakeManager:
        def __init__(self, stream, config):
            self.config, self._stream, self.blamed, self.refreshes = config, stream, [], 0

        async def get_stub(self, peer_id):
            return FakeStub(self._stream)

        def report_congestion(self, peer_id, share):
            self.blamed.append((peer_id, share))

        def request_refresh(self):
            self.refreshes += 1

    async def main():
        peer = PeerID.generate()
        span = RemoteSpanInfo(peer, 0, 2, PortServerInfo(PortState.ONLINE, 1.0, start_block=0, end_block=2))
        stream = FakeStream({"session_open": True, "open_wait_s": 1.25})
        mgr = FakeManager(stream, ClientConfig(alloc_timeout=4.0))
        sess = await _ServerInferenceSession.create(mgr, span, ["m.0", "m.1"], max_length=16, trace_id="abc")
        sent = stream.sent[0]
        assert (sent["alloc_timeout"], sent["client_version"], sent["trace_id"]) == (
            4.0, petals_tpu_torch.__version__, "abc")
        assert sess.hop.queue_share() > 0.5
        assert mgr.blamed and mgr.blamed[0][0] == peer and mgr.blamed[0][1] > 0.5 and mgr.refreshes == 1
        # a mid-range wait is folded into the hop but not blamed; a
        # microsecond one is not recorded at all
        for wait, steps in ((0.2, 1), (1e-5, 0)):
            quiet = FakeStream({"session_open": True, "open_wait_s": wait})
            mgr2 = FakeManager(quiet, ClientConfig())
            sess2 = await _ServerInferenceSession.create(mgr2, span, ["m.0", "m.1"], max_length=16)
            assert "alloc_timeout" not in quiet.sent[0] and sess2.hop.steps == steps
            assert not mgr2.blamed and mgr2.refreshes == 0
        with pytest.raises(RuntimeError, match="Unexpected open reply"):
            await _ServerInferenceSession.create(
                FakeManager(FakeStream({"error": "no"}), ClientConfig()), span, ["m.0"], max_length=16)

    run(main())
