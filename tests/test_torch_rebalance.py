"""The live span move of a port Server (petals_tpu/server/server.py
:1034-1160, the single-host arm): the balance loop moves one of two
servers that hold the same half of tiny-llama to the uncovered half;
``resize`` moves a server that holds a live session, whose KV is pushed to
a replica of its old span, where the client adopts it and its stream goes
on; after each move the pooled decode runs on the new span's weights, on a
new pool, and the tokens equal those of a petals_tpu swarm started at the
new spans. The old span's backend is freed once nothing holds it, and an
out-of-range target is refused."""

import asyncio
import gc
import time
import weakref

import numpy as np
import pytest
import torch

from petals_tpu_torch.client import AutoDistributedModelForCausalLM
from tests.test_torch_client import Route
from tests.test_torch_migration import same_peer, spy_repair_paths
from tests.utils import make_tiny_llama

pytestmark = pytest.mark.timeout(300)

N_LAYERS, HALF = 4, 2
PROMPTS = {seed: np.random.RandomState(seed).randint(1, 100, (1, 5)).astype(np.int64) for seed in (1, 2)}


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def expected(model_path, tmp_path_factory):
    """Greedy streams of a petals_tpu swarm with servers at [0, 2) and [2, 4)."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    route = Route(model_path, [("jax", 0, HALF), ("jax", HALF, HALF)], str(tmp_path_factory.mktemp("jax"))).start()
    model = JaxClient.from_pretrained(model_path, initial_peers=route.initial_peers)
    try:
        return {seed: model.generate(ids, max_new_tokens=6) for seed, ids in PROMPTS.items()}
    finally:
        model.close()
        route.stop()


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError("condition not reached")
        time.sleep(0.05)


def test_balance_loop_then_resize_with_a_live_session(model_path, tmp_path, monkeypatch, expected):
    route = Route(
        model_path,
        [("port", 0, HALF, dict(throughput=10.0)),  # a: no balance loop
         ("port", 0, HALF, dict(throughput=10.0, mean_balance_check_period=0.2))],  # b: moves
        str(tmp_path), server_side_generation=False, prefix_cache_bytes=0,
    ).start()
    a, b = route.servers
    old_backend, old_batcher = weakref.ref(b.backend), b.batcher
    try:
        # the loop sees blocks [2, 4) uncovered and moves b there
        _wait(lambda: b.first_block == HALF and b._state.name == "ONLINE")
        b._balancer_task.cancel()  # no further moves while the sessions run
        assert a.first_block == 0
        assert b.backend.first_block == HALF and b.handler.backend is b.backend
        assert b.batcher is not old_batcher and old_batcher._closed
        assert b.batcher._handles is not None  # the new pool opened before ONLINE
        del old_batcher
        gc.collect()
        assert old_backend() is None, "the old span's weights outlived the move"

        model = AutoDistributedModelForCausalLM.from_pretrained(
            model_path, initial_peers=route.initial_peers, device="cpu", min_backoff=0.1,
        )
        try:
            # pooled decode on b's new weights
            np.testing.assert_array_equal(model.generate(PROMPTS[1], max_new_tokens=6), expected[1])
            assert b.batcher.stats["decode_steps"] + b.batcher.stats["mixed_steps"] > 0

            # a replica of [0, 2) for a's session, then a moves under it
            route.loop.run(_add_server(route, model_path, 0, HALF, throughput=1.0))
            c = route.servers[-1]
            adopts, imports, replays = spy_repair_paths(monkeypatch)
            ids = PROMPTS[2]
            with model.remote.inference_session(max_length=16, batch_size=1) as session:
                first = model.generate(ids, max_new_tokens=3, session=session)
                np.testing.assert_array_equal(first, expected[2][:, : ids.shape[1] + 3])
                assert same_peer(session._session._sessions[0].span.peer_id, a.dht.peer_id)
                assert route.loop.run(a.resize(HALF)) is True
                assert a.first_block == HALF and a.handler.migration_stats["pushes"] == 1
                final = model.generate(first, max_new_tokens=3, session=session)
                assert same_peer(session._session._sessions[0].span.peer_id, c.dht.peer_id)
            np.testing.assert_array_equal(final, expected[2])
            assert adopts == [True] and imports == [] and replays == []
            # a serves the new span's pooled decode: a fresh session over c -> a or b
            np.testing.assert_array_equal(model.generate(PROMPTS[1], max_new_tokens=6), expected[1])
        finally:
            model.close()
    finally:
        route.stop()


async def _add_server(route, path, first, n, **kwargs):
    from petals_tpu_torch.server.server import Server

    server = Server(path, first_block=first, num_blocks=n, initial_peers=route.initial_peers, device="cpu",
                    compute_dtype=torch.float32, server_side_generation=False, prefix_cache_bytes=0, **kwargs)
    await server.start()
    route.servers.append(server)


@pytest.mark.parametrize("target", [-1, N_LAYERS - HALF + 1, 99])
def test_resize_refuses_an_out_of_range_target(model_path, target):
    from petals_tpu_torch.server.server import Server

    server = Server(model_path, first_block=0, num_blocks=HALF, device="cpu", throughput=1.0)
    with pytest.raises(ValueError, match="resize target"):
        asyncio.run(server.resize(target))
    assert asyncio.run(server.resize(0)) is False  # already there: nothing moves
    assert server.first_block == 0
