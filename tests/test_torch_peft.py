"""Server-side LoRA adapters (CPU, float32): the port's utils/peft.py and a
port server with ``adapters=`` against petals_tpu's.

- ``load_adapter`` gives petals_tpu's ``LoadedAdapter`` (name, scaling,
  rank, every block's (A, B) bit for bit), for the whole model and a
  sub-span; ``stack_adapter`` gives zeros where petals_tpu's stacked form
  does (an adapter that skips a block).
- A port server and a petals_tpu server, each hosting two adapters on every
  block of tiny-llama: ``ptu.forward`` (whole span and sub-span),
  ``ptu.backward`` and an inference session (a prefill, decode steps and
  server-side generated tokens) with an ``active_adapter`` equal petals_tpu's
  (atol 1e-4 for the float32 backward, petals_tpu's bound; 1e-5 for the
  forward, as tests/test_torch_forward.py holds it; generated tokens
  exactly); a port client's logits with the adapter equal an HF model with
  the deltas merged into its weights (tests/test_peft.py's ground truth,
  atol 1e-4).
- An unknown adapter is refused on forward, backward and at inference open
  with petals_tpu's text; an adapter session takes no lane and never probes
  or fills the prefix cache; the announce lists the adapters sorted, and a
  client asking for an adapter routes around a server without it.
- The program keys: each adapter's forward and private steps get their own
  graphs (an ``OnceCapture`` stand-in for the card's capture), and
  switching back to an adapter seen before captures nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server.server import Server as JaxServer
from petals_tpu_torch.client.model import AutoDistributedModelForCausalLM as PortModel
from petals_tpu_torch.server.server import Server
from tests.test_torch_backward import make_adapter
from tests.test_torch_forward import _uids
from tests.test_torch_swarm import Loop
from tests.test_torch_training import MiniSwarm
from tests.utils import make_tiny_llama

N_LAYERS = 4
ATOL = 1e-4
FWD_TOL = 1e-5

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def adapters(model_path, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("adapters"))
    return (
        make_adapter(root, model_path, name="lora-a", seed=0),
        make_adapter(root, model_path, name="lora-b", seed=1, rank=2, alpha=4.0,
                     targets=("self_attn.k_proj", "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj"),
                     blocks=(0, 2)),
    )


@pytest.mark.parametrize("block_range", [(0, N_LAYERS), (1, 3)], ids=["whole", "sub"])
@pytest.mark.parametrize("which", [0, 1], ids=["lora-a", "lora-b"])
def test_load_adapter_equals_petals_tpu(model_path, adapters, block_range, which):
    from petals_tpu.utils.peft import load_adapter as jax_load
    from petals_tpu.utils.peft import stack_adapter as jax_stack
    from petals_tpu_torch.utils.peft import load_adapter, stack_adapter

    lo, hi = block_range
    want = jax_load(adapters[which], "llama", block_range=range(lo, hi))
    got = load_adapter(adapters[which], "llama", block_range=range(lo, hi))
    assert (got.name, got.scaling, got.rank) == (want.name, want.scaling, want.rank)
    assert sorted(got.per_block) == sorted(want.per_block)
    for i, leaves in want.per_block.items():
        assert sorted(got.per_block[i]) == sorted(leaves)
        for leaf, (a, b) in leaves.items():
            np.testing.assert_array_equal(got.per_block[i][leaf][0].numpy(), a)
            np.testing.assert_array_equal(got.per_block[i][leaf][1].numpy(), b)
    stacked = jax_stack(want, lo, hi - lo, jnp.float32)
    per_block = stack_adapter(got, lo, hi - lo, torch.float32, "cpu")
    assert len(per_block) == hi - lo
    for leaf, (a, b) in stacked.items():
        for j in range(hi - lo):
            np.testing.assert_array_equal(per_block[j][leaf][0].numpy(), np.asarray(a[j]))
            np.testing.assert_array_equal(per_block[j][leaf][1].numpy(), np.asarray(b[j]))


def test_mistral_resolves_to_llama_targets(adapters):
    """A derived family finds its block architecture's projections (the
    smoke serves Mistral-7B-shaped spans)."""
    from petals_tpu_torch.utils.peft import target_map

    assert target_map("mistral") == target_map("llama") and target_map("mistral")["q_proj"] == "wq"
    assert target_map("mixtral") == {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo"}


class Pair:
    """A port server and a petals_tpu server hosting ``adapters`` on every
    block, each a swarm of one, with a raw RPC client each."""

    def __init__(self, model_path, adapters):
        self.loop = Loop()

        async def boot():
            self.port = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu",
                               compute_dtype=torch.float32, throughput=1.0, adapters=adapters)
            await self.port.start()
            self.jax = JaxServer(model_path, first_block=0, num_blocks=N_LAYERS, compute_dtype=jnp.float32,
                                 use_flash=False, throughput=1.0, adapters=adapters)
            await self.jax.start()
            self.clients = {
                "port": await RpcClient.connect(self.port.host, self.port.rpc_server.port),
                "jax": await RpcClient.connect(self.jax.rpc_server.host, self.jax.rpc_server.port),
            }

        self.loop.run(boot())

    def call(self, which, method, payload):
        return self.loop.run(self.clients[which].call(method, payload, timeout=120))

    def session(self, which, open_msg, steps):
        async def run():
            stream = await self.clients[which].open_stream("ptu.inference")
            await stream.send(open_msg)
            replies = [await stream.recv(timeout=60)]
            for step in steps:
                await stream.send(step)
                replies.append(await stream.recv(timeout=60))
            await stream.end()
            return replies

        return self.loop.run(run())

    def close(self):
        async def down():
            for client in self.clients.values():
                await client.close()
            await self.port.shutdown()
            await self.jax.shutdown()

        self.loop.run(down())
        self.loop.close()


@pytest.fixture(scope="module")
def pair(model_path, adapters):
    p = Pair(model_path, adapters)
    yield p
    p.close()


@pytest.mark.parametrize("adapter", ["lora-a", "lora-b"])
@pytest.mark.parametrize("span", [(0, N_LAYERS), (1, 3)], ids=["whole", "sub"])
def test_forward_and_backward_with_an_adapter_equal_petals_tpu(pair, model_path, adapter, span):
    lo, hi = span
    hsz = pair.port.cfg.hidden_size
    rng = np.random.RandomState(lo * 3 + len(adapter))
    hidden = (rng.standard_normal((2, 8, hsz)) * 0.3).astype(np.float32)
    grad = (rng.standard_normal((2, 8, hsz)) * 0.3).astype(np.float32)
    prompts = (rng.standard_normal((hi - lo, 2, 2, hsz)) * 0.3).astype(np.float32)
    fwd = {"uids": _uids(model_path, lo, hi), "active_adapter": adapter,
           "tensors": {"hidden": serialize_array(hidden), "prompts": serialize_array(prompts)}}
    got, want = (deserialize_array(pair.call(w, "ptu.forward", fwd)["tensors"]["hidden"]) for w in ("port", "jax"))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    plain = deserialize_array(pair.call("port", "ptu.forward", {**fwd, "active_adapter": None})["tensors"]["hidden"])
    assert float(np.abs(np.asarray(plain) - np.asarray(got)).max()) > 1e-3  # the adapter applies
    bwd = {**fwd, "tensors": {**fwd["tensors"], "grad_out": serialize_array(grad)}}
    got, want = (pair.call(w, "ptu.backward", bwd)["tensors"] for w in ("port", "jax"))
    assert sorted(got) == sorted(want) == ["grad_hidden", "grad_prompts"]
    for name in want:
        np.testing.assert_allclose(np.asarray(deserialize_array(got[name])), np.asarray(deserialize_array(want[name])),
                                   rtol=0, atol=ATOL, err_msg=name)


def test_adapter_session_equals_petals_tpu_and_stays_off_the_pool(pair, model_path):
    hsz = pair.port.cfg.hidden_size
    rng = np.random.RandomState(4)
    prefill = (rng.standard_normal((1, 130, hsz)) * 0.3).astype(np.float32)  # past a prefix segment
    step = (rng.standard_normal((1, 1, hsz)) * 0.3).astype(np.float32)
    open_msg = {"uids": _uids(model_path, 0, N_LAYERS), "max_length": 160, "batch_size": 1,
                "active_adapter": "lora-a"}
    steps = [{"tensors": {"hidden": serialize_array(prefill)}},
             {"tensors": {"hidden": serialize_array(step)}},
             {"tensors": {"hidden": serialize_array(step)}, "gen_tokens": 4}]
    handler = pair.port.handler
    probes, acquires = [], []
    real_probe, real_acquire = handler.prefix_cache.probe, pair.port.batcher.acquire_lane

    def probe(keys):
        probes.append(len(keys))
        return real_probe(keys)

    async def acquire_lane(*args, **kwargs):
        acquires.append(1)
        return await real_acquire(*args, **kwargs)

    handler.prefix_cache.probe, pair.port.batcher.acquire_lane = probe, acquire_lane
    try:
        got = pair.session("port", open_msg, steps)
        assert not probes and not acquires
        assert all(r["step_meta"]["variant"] == "private" for r in got[1:])
        # the same prefill without an adapter probes the cache and takes a lane
        pair.session("port", {**open_msg, "active_adapter": None}, steps[:1])
        assert probes and acquires
    finally:
        handler.prefix_cache.probe, pair.port.batcher.acquire_lane = real_probe, real_acquire
    want = pair.session("jax", open_msg, steps)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(np.asarray(deserialize_array(g["tensors"]["hidden"])),
                                   np.asarray(deserialize_array(w["tensors"]["hidden"])), rtol=FWD_TOL, atol=FWD_TOL)
    assert got[3]["tokens"] == want[3]["tokens"] and len(got[3]["tokens"]) == 4


@pytest.mark.parametrize("where", ["forward", "backward", "inference"])
def test_an_unknown_adapter_is_refused(pair, model_path, where):
    hsz = pair.port.cfg.hidden_size
    h = serialize_array(np.zeros((1, 3, hsz), np.float32))
    uids = _uids(model_path, 0, N_LAYERS)
    for which in ("port", "jax"):
        with pytest.raises(Exception, match="Adapter 'nope' is not loaded on this server"):
            if where == "inference":
                pair.session(which, {"uids": uids, "max_length": 8, "active_adapter": "nope"},
                             [{"tensors": {"hidden": h}}])
            else:
                tensors = {"hidden": h, "grad_out": h} if where == "backward" else {"hidden": h}
                pair.call(which, f"ptu.{where}", {"uids": uids, "tensors": tensors, "active_adapter": "nope"})


def _hf_merged_logits(model_path, adapter_path, input_ids):
    """HF's model with the LoRA deltas merged into its weights."""
    import json
    import os

    from transformers import AutoModelForCausalLM

    from petals_tpu_torch.utils.safetensors_io import load_file

    model = AutoModelForCausalLM.from_pretrained(model_path, dtype=torch.float32).eval()
    tensors = load_file(os.path.join(adapter_path, "adapter_model.safetensors"))
    with open(os.path.join(adapter_path, "adapter_config.json")) as f:
        cfg = json.load(f)
    scaling = cfg["lora_alpha"] / cfg["r"]
    with torch.no_grad():
        for key, a in tensors.items():
            if ".lora_A." in key:
                b = tensors[key.replace(".lora_A.", ".lora_B.")]
                module = model.get_submodule(key.replace("base_model.model.", "").replace(".lora_A.weight", ""))
                module.weight += (b @ a) * scaling
        return model(torch.from_numpy(input_ids)).logits.numpy()


def test_port_client_with_an_adapter_equals_hf_merged(pair, model_path, adapters):
    ids = np.random.RandomState(8).randint(0, 100, (2, 7)).astype(np.int64)
    model = PortModel.from_pretrained(model_path, initial_peers=[pair.port.dht.own_addr.to_string()], device="cpu",
                                      active_adapter="lora-a")
    try:
        got = model.forward(ids)
    finally:
        model.close()
    np.testing.assert_allclose(got.detach().numpy(), _hf_merged_logits(model_path, adapters[0], ids), rtol=0, atol=ATOL)


def test_announce_lists_adapters_and_routing_skips_a_server_without_one(model_path, adapters, tmp_path_factory):
    from petals_tpu_torch.data_structures import ServerState

    swarm = MiniSwarm(model_path, [("port", 0, N_LAYERS, {}), ("port", 0, N_LAYERS, {"adapters": adapters[::-1]})],
                      str(tmp_path_factory.mktemp("cache"))).start()
    try:
        plain, hosting = swarm.servers
        assert hosting._server_info(ServerState.ONLINE).adapters == ("lora-a", "lora-b")
        assert plain._server_info(ServerState.ONLINE).adapters == ()
        model = PortModel.from_pretrained(model_path, initial_peers=swarm.initial_peers, device="cpu",
                                          active_adapter="lora-b")
        try:
            sm = model.remote.sequence_manager
            for _ in range(3):
                chain = model.remote.runtime.run(sm.make_sequence(0, N_LAYERS, mode="max_throughput"))
                assert [s.peer_id for s in chain] == [hosting.dht.peer_id]
            ids = np.random.RandomState(9).randint(0, 100, (1, 5)).astype(np.int64)
            assert np.isfinite(model.forward(ids).detach().numpy()).all()
        finally:
            model.close()
    finally:
        swarm.stop()


def test_program_keys_tell_adapters_apart(pair):
    from tests.test_torch_dense_programs import _stubbed

    stub, obs = _stubbed(pair.port.backend)
    hsz = stub.hidden_size
    hidden = torch.from_numpy((np.random.RandomState(2).standard_normal((1, 12, hsz)) * 0.3).astype(np.float32))
    outs = {}
    for name in (None, "lora-a", "lora-b"):
        for _ in range(2):  # an eager call, then the capture
            outs[name] = stub.forward(hidden, active_adapter=name)
    prog = stub._forward_program
    assert prog.counts.captures == 3
    for name in ("lora-b", None, "lora-a"):  # back to each: replays only
        np.testing.assert_array_equal(stub.forward(hidden, active_adapter=name).numpy(), outs[name].numpy())
    assert prog.counts.captures == 3 and prog.counts.replays == 6
    assert len({tuple(map(str, k)) for k in prog._entries}) == 3
    # a private cache's steps likewise: one graph per adapter
    k, v = (torch.zeros(N_LAYERS, 1, 32, stub.num_kv_heads, stub.head_dim) for _ in range(2))
    for name in ("lora-a", "lora-b", "lora-a"):
        stub.inference_step(hidden[:, :1], (k, v), 0, active_adapter=name)
        stub.inference_step(hidden[:, :1], (k, v), 0, active_adapter=name)
    keys = {key[-1] for key in stub._private_program._entries}
    assert keys == {"lora-a", "lora-b"} and stub._private_program.counts.captures == 2
