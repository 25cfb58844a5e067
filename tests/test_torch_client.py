"""The port's client on the CPU against petals_tpu's client
(``petals_tpu.client.model.AutoDistributedModelForCausalLM``), both driving
the same servers: one port Server on tiny-llama's whole span here (the mixed
chains: tests/test_torch_client_mixed.py; petals_tpu servers:
tests/test_torch_client_jax.py).

The server does not generate (``server_side_generation=False``), so both
clients run their per-token loops; their server-side generation paths are
compared in tests/test_torch_client_jax.py.

Compared token array for token array: greedy, a batch of 3, seeded sampling
(tests/test_full_model.py's SAMPLING), a two-call chat session, 2-beam
search, repetition penalty with no_repeat_ngram_size, eos/pad with and
without min_new_tokens, and the streamer's pieces. The greedy stream also
equals HF's, a Qwen2 (tied) checkpoint's greedy stream equals petals_tpu's
client's and HF's, and a RemoteSequential slice's step equals petals_tpu's.

Every wait is bounded: the servers' loop calls (``Loop.run``) and the
clients' RPC timeouts."""

import numpy as np
import pytest
import torch

from petals_tpu_torch.client import AutoDistributedModelForCausalLM, ClientConfig
from tests.test_torch_swarm import Loop
from tests.utils import make_tiny_llama, make_tiny_qwen2

N_LAYERS = 4
SAMPLING = dict(do_sample=True, top_k=10, temperature=0.8, seed=7)  # tests/test_full_model.py's

pytestmark = pytest.mark.timeout(600)


class Route:
    """A petals_tpu DHT bootstrap and the servers of one route on a loop
    thread of their own. ``specs``: (kind, first_block, num_blocks[, server
    kwargs]) with kind "port" (a port Server on the CPU, float32) or "jax";
    every server announces throughput 1.0 unless its kwargs say otherwise."""

    def __init__(self, path, specs, cache_dir, **server_kwargs):
        self.path, self.specs, self.cache_dir, self.server_kwargs = path, specs, cache_dir, server_kwargs
        self.loop = Loop()
        self.servers = []

    def start(self):
        import jax.numpy as jnp

        from petals_tpu.dht import DHTNode as JaxDHTNode
        from petals_tpu.server.server import Server as JaxServer
        from petals_tpu_torch.server.server import Server

        async def boot():
            self.bootstrap = await JaxDHTNode.create(maintenance_period=1000)
            for kind, first, n, *extra in self.specs:
                kwargs = {"throughput": 1.0, **self.server_kwargs, **(extra[0] if extra else {})}
                if kind == "jax":
                    server = JaxServer(
                        self.path, first_block=first, num_blocks=n, initial_peers=[self.bootstrap.own_addr],
                        compute_dtype=jnp.float32, use_flash=False, **kwargs,
                    )
                else:
                    server = Server(
                        self.path, first_block=first, num_blocks=n,
                        initial_peers=[self.bootstrap.own_addr.to_string()], device="cpu",
                        compute_dtype=torch.float32, **kwargs,
                    )
                await server.start()
                self.servers.append(server)

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


def both_clients(path, initial_peers, **config):
    """(petals_tpu's client, the port's client on the CPU) over one swarm."""
    from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxClient

    jax_model = JaxClient.from_pretrained(path, initial_peers=initial_peers, **config)
    port_model = AutoDistributedModelForCausalLM.from_pretrained(path, initial_peers=initial_peers, device="cpu", **config)
    return jax_model, port_model


class Recorder:
    """An HF streamer: the prompt, then each new token, then end()."""

    def __init__(self):
        self.chunks, self.ended = [], False

    def put(self, value):
        self.chunks.append(np.asarray(value).copy())

    def end(self):
        self.ended = True


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(1, 100, shape).astype(np.int64)


def case_greedy(model):
    return [model.generate(_ids(1, (1, 6)), max_new_tokens=8)]


def case_batched(model):
    return [model.generate(_ids(2, (3, 5)), max_new_tokens=4)]


def case_sampled(model):
    ids = _ids(3, (1, 4))
    return [model.generate(ids, max_new_tokens=8, **SAMPLING), model.generate(ids, max_new_tokens=8, **SAMPLING)]


def case_chat(model):
    with model.inference_session(max_length=32):
        first = model.generate(_ids(4, (1, 4)), max_new_tokens=3)
        second = model.generate(first, max_new_tokens=3)
    return [first, second]


def case_beam(model):
    return [model.generate(_ids(5, (1, 4)), max_new_tokens=6, num_beams=2)]


def case_penalties(model):
    return [model.generate(_ids(13, (2, 6)), max_new_tokens=8, repetition_penalty=1.5, no_repeat_ngram_size=2)]


def case_eos_pad(model):
    ids = _ids(14, (2, 5))
    free = model.generate(ids, max_new_tokens=8)
    eos = int(free[0, 7])  # row 0's third new token
    stopped = model.generate(ids, max_new_tokens=8, eos_token_id=eos, pad_token_id=0)
    held = model.generate(ids, max_new_tokens=8, eos_token_id=eos, pad_token_id=0, min_new_tokens=3)
    return [free, stopped, held]


def case_return_sequences(model):
    """num_return_sequences by sampling (independent draws) and by beams."""
    ids = _ids(16, (1, 4))
    return [model.generate(ids, max_new_tokens=5, num_return_sequences=2, **SAMPLING),
            model.generate(ids, max_new_tokens=5, num_beams=2, num_return_sequences=2)]


def case_processors(model):
    """HF-protocol logits processors and stopping criteria over numpy, and
    max_length capping the total length."""
    ids = _ids(15, (1, 5))

    def ban_odd(input_ids, scores):
        return np.where(np.arange(scores.shape[-1]) % 2 == 1, -np.inf, scores)

    def stop_at_9(input_ids, scores):
        return input_ids.shape[1] >= 9

    return [model.generate(ids, max_new_tokens=8, logits_processor=[ban_odd], stopping_criteria=[stop_at_9]),
            model.generate(ids, max_new_tokens=8, max_length=8)]


def case_streamer(model):
    rec = Recorder()
    out = model.generate(_ids(11, (1, 5)), max_new_tokens=6, streamer=rec)
    assert rec.ended
    return rec.chunks + [out]


CASES = {
    "greedy": case_greedy, "batched": case_batched, "sampled": case_sampled, "chat": case_chat,
    "beam": case_beam, "penalties": case_penalties, "eos_pad": case_eos_pad, "streamer": case_streamer,
    "return_sequences": case_return_sequences, "processors": case_processors,
}


def assert_same_streams(jax_model, port_model, case):
    want, got = CASES[case](jax_model), CASES[case](port_model)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, np.ndarray) and g.dtype == np.int64, (case, i, type(g))
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{case}[{i}]")
    return got


def hf_greedy(path, input_ids, max_new_tokens):
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(path, dtype=torch.float32).eval()
    with torch.no_grad():
        return model.generate(torch.from_numpy(input_ids), max_new_tokens=max_new_tokens, do_sample=False).numpy()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def port_route(model_path, tmp_path_factory):
    # the per-token path: a whole-model server that generated would take
    # both clients' batch-1 calls (tests/test_torch_client_jax.py)
    route = Route(
        model_path, [("port", 0, N_LAYERS)], str(tmp_path_factory.mktemp("cache")), server_side_generation=False,
    ).start()
    jax_model, port_model = both_clients(model_path, route.initial_peers)
    yield route, jax_model, port_model
    port_model.close()
    jax_model.close()
    route.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_port_client_equals_jax_client_over_one_port_server(port_route, case):
    route, jax_model, port_model = port_route
    got = assert_same_streams(jax_model, port_model, case)
    if case == "greedy":
        np.testing.assert_array_equal(got[0], hf_greedy(route.path, _ids(1, (1, 6)), 8))
    if case == "sampled":
        np.testing.assert_array_equal(got[0], got[1])  # the same seed, the same stream
    if case == "processors":
        assert got[0].shape == (1, 9) and (got[0][0, 5:] % 2 == 0).all() and got[1].shape == (1, 8)
    assert route.servers[0].batcher.stats["batched_steps"] > 0


def test_remote_sequential_slice_and_usage(port_route):
    """A slice of the chain steps like petals_tpu's slice; a session's
    usage report counts its tokens (a port server bills nothing yet)."""
    route, jax_model, port_model = port_route
    hidden = np.random.RandomState(6).randn(1, 5, port_model.cfg.hidden_size).astype(np.float32)
    outs = []
    for model in (jax_model, port_model):
        sub = model.remote[1:3]
        try:
            assert len(sub) == 2
            with sub.inference_session(max_length=8) as session:
                outs.append(np.asarray(session.step(hidden)))
                assert session.position == 5
        finally:
            sub.close()
    np.testing.assert_array_equal(outs[1], outs[0])
    with port_model.remote.inference_session(max_length=8) as session:
        session.step(torch.from_numpy(hidden))
        report = session.usage_report()
    assert report["tokens"] == 5 and report["total"] == {} and len(report["trace_id"]) == 16


def test_session_rollback_replays_from_a_position(port_route):
    """Setting a session's position back (speculative decoding's rollback)
    makes the next step overwrite the servers' caches from there and trims
    the recorded history to it."""
    _, _, port_model = port_route
    rng = np.random.RandomState(7)
    prompt, step = (torch.from_numpy(rng.randn(1, n, port_model.cfg.hidden_size).astype(np.float32)) for n in (5, 1))
    other = torch.from_numpy(rng.randn(1, 1, port_model.cfg.hidden_size).astype(np.float32))
    with port_model.remote.inference_session(max_length=16) as session:
        session.step(prompt)
        want = session.step(step)
        session.step(other)
        assert session.position == 7
        session.position = 5
        got = session.step(step)
        inner = session._session._sessions[0]
        assert session.position == 6 and [h.shape[1] for h, _ in inner.history_steps()] == [5, 1]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(AssertionError, match="roll back"):
        session._session.position = 9


def test_waiting_parts_raise_with_their_slice(port_route):
    _, _, port_model = port_route
    with pytest.raises(NotImplementedError, match="A11"):
        port_model.forward(_ids(1, (1, 4)))
    with pytest.raises(NotImplementedError, match="A11"):
        port_model.remote.forward(torch.zeros(1, 4, port_model.cfg.hidden_size))
    with pytest.raises(NotImplementedError, match="A13"):
        port_model.generate(_ids(1, (1, 4)), max_new_tokens=2, prompts=np.zeros((4, 1, 2, 64), np.float32))
    for bad, slice_name in ((dict(route_upgrade_period=5.0), "A9"), (dict(route_upgrade_threshold=0.5), "A9"),
                            (dict(kv_export_timeout=10.0), "A9"), (dict(handoff_timeout=5.0), "A9"),
                            (dict(compression="qint8"), "A3"), (dict(active_adapter="lora"), "A13")):
        with pytest.raises(NotImplementedError, match=slice_name):
            ClientConfig(**bad)
    assert ClientConfig().use_server_to_server and ClientConfig().disagg_handoff  # inert defaults
    # False asks for what the port does (the client relays, no handoff)
    ClientConfig(use_server_to_server=False, disagg_handoff=False)
    # the head is held in float32 once, and the logits are float32
    assert port_model.client_params["head"].dtype == torch.float32
    assert port_model.lm_logits(torch.zeros(1, 1, port_model.cfg.hidden_size)).dtype == torch.float32


def test_qwen2_greedy_over_a_port_server(tmp_path_factory):
    path = make_tiny_qwen2(str(tmp_path_factory.mktemp("models")), n_layers=2)
    route = Route(path, [("port", 0, 2)], str(tmp_path_factory.mktemp("cache"))).start()
    try:
        jax_model, port_model = both_clients(path, route.initial_peers)
        try:
            # tied: the head is the embeddings' transpose, not a copy
            head, embed = port_model.client_params["head"], port_model.client_params["embed"]
            assert head.data_ptr() == embed.data_ptr() and head.shape == embed.t().shape
            ids = _ids(21, (1, 6))
            got = port_model.generate(ids, max_new_tokens=8)
            np.testing.assert_array_equal(got, jax_model.generate(ids, max_new_tokens=8))
            np.testing.assert_array_equal(got, hf_greedy(path, ids, 8))
        finally:
            port_model.close()
            jax_model.close()
    finally:
        route.stop()


@pytest.mark.parametrize("make_model", [make_tiny_llama, make_tiny_qwen2], ids=["llama", "qwen2_tied"])
def test_client_params_embed_and_head_equal_petals_tpu(make_model, tmp_path):
    """The client's own loader and the converter of the JAX client's numpy
    parameters give the same tensors; embed is exact and the float32 head
    within 1e-5 of petals_tpu's (float32 products summed in another order)."""
    import jax

    from petals_tpu.client.from_pretrained import load_client_params as jax_load_client
    from petals_tpu.models.registry import get_family as jax_get_family
    from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
    from petals_tpu_torch.client.from_pretrained import load_client_params
    from petals_tpu_torch.server.from_pretrained import get_block_config
    from petals_tpu_torch.utils.convert import client_params_from_numpy

    path = make_model(str(tmp_path), n_layers=2)
    jfamily, jcfg = jax_block_config(path)
    jparams = jax_load_client(path, family=jfamily, cfg=jcfg)
    family, cfg = get_block_config(path)
    own = load_client_params(path, device="cpu", family=family, cfg=cfg)
    carried = client_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    assert sorted(own) == sorted(carried) == ["embed", "head", "norm"]
    for name in own:
        assert own[name].dtype == carried[name].dtype == torch.float32
        np.testing.assert_array_equal(own[name].numpy(), carried[name].numpy(), err_msg=name)
    ids = _ids(8, (2, 7)) % cfg.vocab_size
    np.testing.assert_array_equal(
        family.client_embed(own, torch.from_numpy(ids), cfg).numpy(),
        np.asarray(jax_get_family(jfamily.name).client_embed(jparams, ids, jcfg)),
    )
    hidden = np.random.RandomState(9).randn(2, 3, cfg.hidden_size).astype(np.float32)
    np.testing.assert_allclose(
        family.client_head(own, torch.from_numpy(hidden), cfg).numpy(),
        np.asarray(jfamily.client_head(jparams, hidden, jcfg)), atol=1e-5, rtol=0,
    )


def test_bare_model_keeps_no_head_and_norms_as_petals_tpu(port_route):
    """AutoDistributedModel: embeddings and the final norm, no head; its
    final norm equals petals_tpu's client_norm (float32, 1e-6)."""
    from petals_tpu.client.model import AutoDistributedModel as JaxBare
    from petals_tpu_torch.client import AutoDistributedModel

    route = port_route[0]
    jax_bare = JaxBare.from_pretrained(route.path, initial_peers=route.initial_peers)
    bare = AutoDistributedModel.from_pretrained(route.path, initial_peers=route.initial_peers, device="cpu")
    try:
        assert sorted(bare.client_params) == ["embed", "norm"]
        hidden = np.random.RandomState(12).randn(2, 3, bare.cfg.hidden_size).astype(np.float32)
        want = jax_bare.family.client_norm(jax_bare.client_params, hidden, jax_bare.cfg)
        np.testing.assert_allclose(bare.final_norm(torch.from_numpy(hidden)).numpy(), np.asarray(want), atol=1e-6, rtol=0)
        with pytest.raises(NotImplementedError, match="A11"):
            bare.forward(_ids(1, (1, 4)))
    finally:
        bare.close()
        jax_bare.close()
