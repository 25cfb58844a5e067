"""Training through a swarm (CPU, float32): the wire of ``ptu.backward``
both ways, the client's repair path, and the port client's training
against petals_tpu's.

- The wire: a port client's ``RemoteSequential.backward`` through two
  petals_tpu servers, and a petals_tpu client's through a chain whose second
  half is a port server, each equal to a petals_tpu client's over two
  petals_tpu servers; the port client over the mixed chain likewise.
- The repair: the first span has two port servers; the one the forward used
  stops before the backward, and the backward's gradients still equal the
  gradients taken while it served.
- ``client/training.py``: ``compute_loss_and_grads`` under "ptune" and
  "deep_ptune" equals ``petals_tpu.client.training``'s from the same
  prompts (the JAX arrays carried across with ``set_trainable_params``);
  the shallow prompts' gradient equals ``petals_tpu.compat.torch_model``'s
  torch gradient on the same swarm; three ``sgd_step``s lower the loss; a
  torch optimizer over the model's ``nn.Parameter``s lowers it too; a
  forward with trained prompts and greedy generation with deep prompts run
  as petals_tpu's.

Float32 throughout: atol 1e-4 (petals_tpu's own bound, tests/test_training.py);
the loss within 1e-5. Every wait is bounded."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.client.model import AutoDistributedModelForCausalLM as JaxModel
from petals_tpu.client.ptune import PTuneConfig as JaxPTuneConfig
from petals_tpu.client.training import compute_loss_and_grads as jax_loss_and_grads
from petals_tpu.dht import DHTNode as JaxDHTNode
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.client import PTuneConfig
from petals_tpu_torch.client.model import AutoDistributedModelForCausalLM as PortModel
from petals_tpu_torch.client.training import compute_loss_and_grads, sgd_step
from petals_tpu_torch.server.server import Server
from tests.test_torch_swarm import Loop
from tests.utils import make_tiny_llama

N_LAYERS = 4
ATOL = 1e-4
PRE_SEQ = 3

pytestmark = pytest.mark.timeout(600)


class MiniSwarm:
    """A petals_tpu bootstrap and servers on one loop thread; ``specs`` are
    (kind, first_block, num_blocks, kwargs), kind "jax" or "port"."""

    def __init__(self, path, specs, cache_dir):
        self.path, self.specs, self.cache_dir = path, specs, cache_dir
        self.loop = Loop()
        self.servers = []

    def start(self):
        async def boot():
            self.bootstrap = await JaxDHTNode.create(maintenance_period=1000)
            peers = [self.bootstrap.own_addr]
            for kind, first, n, kwargs in self.specs:
                if kind == "jax":
                    server = JaxServer(self.path, first_block=first, num_blocks=n, initial_peers=peers,
                                       compute_dtype=jnp.float32, use_flash=False, throughput=1.0, **kwargs)
                else:
                    server = Server(self.path, first_block=first, num_blocks=n,
                                    initial_peers=[p.to_string() for p in peers], device="cpu",
                                    compute_dtype=torch.float32, throughput=1.0, **kwargs)
                await server.start()
                self.servers.append(server)

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PETALS_TPU_TORCH_CACHE", self.cache_dir)
            self.loop.run(boot())
        return self

    @property
    def initial_peers(self):
        return [self.bootstrap.own_addr.to_string()]

    def stop_server(self, server):
        self.loop.run(server.shutdown())
        self.servers.remove(server)

    def stop(self):
        async def teardown():
            for server in self.servers:
                await server.shutdown()
            await self.bootstrap.shutdown()

        self.loop.run(teardown())
        self.loop.close()


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def swarms(model_path, tmp_path_factory):
    half = N_LAYERS // 2
    jax_swarm = MiniSwarm(model_path, [("jax", 0, half, {}), ("jax", half, half, {})],
                          str(tmp_path_factory.mktemp("cache"))).start()
    mixed = MiniSwarm(model_path, [("jax", 0, half, {}), ("port", half, half, {})],
                      str(tmp_path_factory.mktemp("cache"))).start()
    yield jax_swarm, mixed
    mixed.stop()
    jax_swarm.stop()


def _inputs(hsz, seed=21):
    rng = np.random.RandomState(seed)
    hidden = (rng.standard_normal((2, 7, hsz)) * 0.3).astype(np.float32)
    grad = (rng.standard_normal((2, 7, hsz)) * 0.3).astype(np.float32)
    prompts = (rng.standard_normal((N_LAYERS, 2, 2, hsz)) * 0.3).astype(np.float32)
    return hidden, grad, prompts


def _jax_backward(model, hidden, grad, prompts):
    out, histories, spans = model.remote.forward_with_state(hidden, prompts=prompts)
    g_h, g_p = model.remote.backward(grad, histories, spans, prompts=prompts)
    return np.asarray(out), np.asarray(g_h), np.asarray(g_p)


def _port_backward(model, hidden, grad, prompts):
    out, histories, spans = model.remote.forward_with_state(hidden, prompts)
    g_h, g_p = model.remote.backward(grad, histories, spans, prompts=prompts)
    return out.numpy(), g_h.numpy(), g_p.numpy()


@pytest.fixture(scope="module")
def reference(swarms, model_path):
    """A petals_tpu client's forward and backward over two petals_tpu servers."""
    jax_swarm, _ = swarms
    model = JaxModel.from_pretrained(model_path, initial_peers=jax_swarm.initial_peers)
    try:
        return _jax_backward(model, *_inputs(model.cfg.hidden_size))
    finally:
        model.close()


@pytest.mark.parametrize("client,chain", [("port", "jax"), ("jax", "mixed"), ("port", "mixed")])
def test_backward_over_the_wire_equals_all_petals_tpu(swarms, model_path, reference, client, chain):
    jax_swarm, mixed = swarms
    peers = (jax_swarm if chain == "jax" else mixed).initial_peers
    if client == "jax":
        model = JaxModel.from_pretrained(model_path, initial_peers=peers)
        run = _jax_backward
    else:
        model = PortModel.from_pretrained(model_path, initial_peers=peers, device="cpu")
        run = _port_backward
    try:
        got = run(model, *_inputs(model.cfg.hidden_size))
    finally:
        model.close()
    for g, w, what in zip(got, reference, ("output", "grad_hidden", "grad_prompts")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("compression", ["float16", "bfloat16"])
def test_backward_honours_the_wire_codec(swarms, model_path, reference, compression):
    """The client's compression rides both ways: the replies come back in the
    asked codec, within its rounding of the reference."""
    _, mixed = swarms
    model = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu",
                                      compression=compression)
    try:
        got = _port_backward(model, *_inputs(model.cfg.hidden_size))
    finally:
        model.close()
    rel = {"float16": 2e-2, "bfloat16": 1e-1}[compression]
    for g, w in zip(got, reference):
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


def test_backward_repairs_a_span_whose_server_stopped(model_path, tmp_path_factory):
    half = N_LAYERS // 2
    swarm = MiniSwarm(model_path, [("port", 0, half, {}), ("port", 0, half, {}), ("port", half, half, {})],
                      str(tmp_path_factory.mktemp("cache"))).start()
    try:
        model = PortModel.from_pretrained(model_path, initial_peers=swarm.initial_peers, device="cpu",
                                          min_backoff=0.05, max_backoff=0.2)
        try:
            hidden, grad, prompts = _inputs(model.cfg.hidden_size, seed=5)
            _, want_h, want_p = _port_backward(model, hidden, grad, prompts)
            out, histories, spans = model.remote.forward_with_state(hidden, prompts)
            first = next(s for s in swarm.servers if s.dht.peer_id == spans[0].peer_id)
            assert (first.first_block, first.num_blocks) == (0, half)
            swarm.stop_server(first)
            got_h, got_p = model.remote.backward(grad, histories, spans, prompts=prompts)
            np.testing.assert_allclose(got_h.numpy(), want_h, rtol=0, atol=ATOL)
            np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=ATOL)
        finally:
            model.close()
    finally:
        swarm.stop()


# ---------------------------------------------------------------- client/training.py


def _ids_and_labels(seed=3):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 100, (2, 6)).astype(np.int64)
    return ids, ids.copy()


@pytest.mark.parametrize("mode", ["ptune", "deep_ptune"])
def test_compute_loss_and_grads_equals_petals_tpu(swarms, model_path, mode):
    jax_swarm, mixed = swarms
    jmodel = JaxModel.from_pretrained(model_path, initial_peers=jax_swarm.initial_peers,
                                      ptune=JaxPTuneConfig(PRE_SEQ, mode))
    pmodel = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu",
                                       ptune=PTuneConfig(PRE_SEQ, mode))
    try:
        # the same starting prompts: petals_tpu's, carried across
        pmodel.set_trainable_params({k: np.array(v) for k, v in jmodel.trainable_params().items()})
        ids, labels = _ids_and_labels()
        want_loss, want = jax_loss_and_grads(jmodel, ids, labels)
        loss, grads = compute_loss_and_grads(pmodel, ids, labels)
        assert set(grads) == set(want) == {"prompt_embeddings"} | ({"deep_prompt_embeddings"} if mode == "deep_ptune" else set())
        assert abs(loss - want_loss) <= 1e-5
        for name in want:
            assert tuple(grads[name].shape) == tuple(want[name].shape)
            np.testing.assert_allclose(grads[name].numpy(), np.asarray(want[name]), rtol=0, atol=ATOL, err_msg=name)
        # a forward with the trained prompts: petals_tpu's logits
        np.testing.assert_allclose(pmodel.forward(ids).detach().numpy(), np.asarray(jmodel.forward(ids)),
                                   rtol=0, atol=ATOL)
    finally:
        pmodel.close()
        jmodel.close()


def test_port_gradients_equal_the_compat_torch_model(swarms, model_path):
    from petals_tpu.compat.torch_model import TorchDistributedModelForCausalLM

    _, mixed = swarms
    compat = TorchDistributedModelForCausalLM.from_pretrained(model_path, initial_peers=mixed.initial_peers,
                                                              pre_seq_len=PRE_SEQ)
    pmodel = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu",
                                       ptune=PTuneConfig(PRE_SEQ, "ptune"))
    try:
        pmodel.set_trainable_params({"prompt_embeddings": compat.prompt_embeddings.detach().clone()})
        ids, labels = _ids_and_labels(7)
        out = compat(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        out.loss.backward()
        loss, grads = compute_loss_and_grads(pmodel, ids, labels)
        assert abs(loss - float(out.loss.detach())) <= 1e-5
        np.testing.assert_allclose(grads["prompt_embeddings"].numpy(), compat.prompt_embeddings.grad.numpy(),
                                   rtol=0, atol=ATOL)
    finally:
        pmodel.close()
        compat.close()


def test_sgd_steps_and_a_torch_optimizer_lower_the_loss(swarms, model_path):
    _, mixed = swarms
    model = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu",
                                      ptune=PTuneConfig(PRE_SEQ, "deep_ptune"))
    try:
        ids, labels = _ids_and_labels(11)
        losses = []
        for _ in range(3):
            loss, grads = compute_loss_and_grads(model, ids, labels)
            losses.append(loss)
            sgd_step(model, grads, lr=0.5)
        losses.append(compute_loss_and_grads(model, ids, labels)[0])
        assert losses[-1] < losses[0] and all(b < a for a, b in zip(losses, losses[1:])), losses
        # a torch optimizer over the model's parameters, through loss.backward()
        params = model.parameters()
        assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad for p in params) and len(params) == 2
        opt = torch.optim.Adam(params, lr=0.05)
        first = None
        for _ in range(3):
            opt.zero_grad()
            logits = model.forward(ids)  # the shallow prompts' positions cut off
            loss = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                                     torch.from_numpy(labels[:, 1:]).reshape(-1))
            loss.backward()
            assert all(p.grad is not None and float(p.grad.abs().max()) > 0 for p in params)
            opt.step()
            first = float(loss) if first is None else first
        with torch.no_grad():
            logits = model.forward(ids)
            after = float(torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                                                            torch.from_numpy(labels[:, 1:]).reshape(-1)))
        assert after < first
    finally:
        model.close()


def test_generation_with_deep_prompts_equals_petals_tpu(swarms, model_path):
    jax_swarm, mixed = swarms
    jmodel = JaxModel.from_pretrained(model_path, initial_peers=jax_swarm.initial_peers,
                                      ptune=JaxPTuneConfig(PRE_SEQ, "deep_ptune"))
    pmodel = PortModel.from_pretrained(model_path, initial_peers=mixed.initial_peers, device="cpu",
                                       ptune=PTuneConfig(PRE_SEQ, "deep_ptune"))
    try:
        pmodel.set_trainable_params({k: np.array(v) for k, v in jmodel.trainable_params().items()})
        ids = _ids_and_labels(13)[0][:1]
        want = np.asarray(jmodel.generate(ids, max_new_tokens=4))
        got = pmodel.generate(ids, max_new_tokens=4)
        np.testing.assert_array_equal(got, want)
        beams = pmodel.generate(ids, max_new_tokens=3, num_beams=2)
        np.testing.assert_array_equal(beams, np.asarray(jmodel.generate(ids, max_new_tokens=3, num_beams=2)))
    finally:
        pmodel.close()
        jmodel.close()
