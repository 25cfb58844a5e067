"""LoRA adapters on a tensor-parallel span (CPU, float32): each shard takes
its part of an adapter's pairs (utils/peft.py ``shard_adapter``), as
petals_tpu wraps its sharded leaves in ``LoraLinear`` under a mesh.

- The shards' A / B: an output-split leaf (wq, wv) keeps A whole and takes
  its columns of B, an input-split leaf (wd, wo) takes its rows of A and
  keeps B whole, against a JAX ``TransformerBackend(mesh=tp 2)``'s
  ``LoraLinear`` leaves (their pairs, cut the same way), bit for bit; the
  same at tp=2 x sp=2, where sp ranks on one device share the wrapped dict.
- A tp=2 backend's forward and backward with the adapter within 2e-5 of a
  tp=1 port backend's (tests/test_torch_tp.py's tolerance), and the adapter
  applies.
- A port ``num_tp_devices=2`` server with the adapter against a petals_tpu
  one: an adapter session's replies within tests/test_torch_peft.py's 1e-5
  and its server-side greedy tokens exactly, a forward and a backward over
  the wire.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.parallel.mesh import make_mesh
from petals_tpu.rpc import RpcClient
from petals_tpu.rpc.serialization import deserialize_array, serialize_array
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu.server.server import Server as JaxServer
from petals_tpu.utils.peft import LoraLinear as JaxLoraLinear
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.server.server import Server
from petals_tpu_torch.utils.peft import LoraLinear
from tests.test_torch_backward import make_adapter
from tests.test_torch_forward import _uids
from tests.test_torch_swarm import Loop
from tests.test_torch_tp import _jax_blocks, _port_blocks, _stack
from tests.utils import make_tiny_llama

N_LAYERS = 2
TOL = 2e-5
FWD_TOL = 1e-5  # tests/test_torch_peft.py's
ATOL = 1e-4
TARGETS = ("self_attn.q_proj", "self_attn.v_proj", "self_attn.o_proj", "mlp.down_proj")

pytestmark = pytest.mark.timeout(600)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    return make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def adapter(model_path, tmp_path_factory):
    return make_adapter(str(tmp_path_factory.mktemp("adapters")), model_path, name="lora-tp", seed=3, rank=4,
                        targets=TARGETS)


def _load(adapter_path, n_blocks):
    """(JAX stacked pairs, port per-block pairs, scaling), float32."""
    from petals_tpu.utils.peft import load_adapter as jax_load
    from petals_tpu.utils.peft import stack_adapter as jax_stack
    from petals_tpu_torch.utils.peft import load_adapter, stack_adapter

    jloaded = jax_load(adapter_path, "llama", block_range=range(n_blocks))
    loaded = load_adapter(adapter_path, "llama", block_range=range(n_blocks))
    return (jax_stack(jloaded, 0, n_blocks, jnp.float32), stack_adapter(loaded, 0, n_blocks, torch.float32, "cpu"),
            loaded.scaling)


def _port_backend(model_path, adapter_path, devices=None, n_sp=1):
    _, _, blocks = _jax_blocks(model_path)
    family, cfg = get_block_config(model_path)
    backend = TransformerBackend(family, cfg, _port_blocks(blocks), first_block=0, n_blocks=len(blocks), device="cpu",
                                 compute_dtype=torch.float32, tp_devices=devices, num_sp_devices=n_sp)
    _, per_block, scaling = _load(adapter_path, len(blocks))
    backend.adapters["lora-tp"] = (per_block, scaling)
    return backend


@pytest.mark.parametrize("n_tp,n_sp", [(2, 1), (2, 2)])
def test_shard_pairs_equal_the_jax_mesh_leaves(model_path, adapter, n_tp, n_sp):
    jfamily, jcfg, blocks = _jax_blocks(model_path)
    jb = JaxBackend(jfamily, jcfg, _stack(blocks), first_block=0, n_blocks=len(blocks),
                    memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
                    mesh=make_mesh((n_tp,), ("tp",)))
    stacked, _, scaling = _load(adapter, len(blocks))
    jb.adapters["lora-tp"] = (stacked, scaling)
    jparams = jb.params_for("lora-tp")
    port = _port_backend(model_path, adapter, ["cpu"] * (n_tp * n_sp), n_sp)
    wrapped = port.params_for("lora-tp")
    axes = {"wq": -1, "wv": -1, "wo": -2, "wd": -2}
    for i, block in enumerate(wrapped):
        ranks = block.ranks if n_sp > 1 else [block]
        if n_sp > 1:  # one device: the ranks share each wrapped shard dict
            assert all(a is b for a, b in zip(ranks[0], ranks[1]))
        for t, shard in enumerate(ranks[0]):
            for leaf, axis in axes.items():
                jleaf = jparams[leaf]
                assert isinstance(jleaf, JaxLoraLinear)
                a, b = np.asarray(jleaf.lora_a[i]), np.asarray(jleaf.lora_b[i])
                if axis == -1:
                    cols = b.shape[-1] // n_tp
                    want_a, want_b = a, b[:, t * cols : (t + 1) * cols]
                else:
                    rows = a.shape[-2] // n_tp
                    want_a, want_b = a[t * rows : (t + 1) * rows], b
                got = shard[leaf]
                assert isinstance(got, LoraLinear) and got.scaling == jleaf.scaling
                base = port.block_params[i]
                assert got.base is (base.ranks[0] if n_sp > 1 else base)[t][leaf]  # no copy of the weights
                np.testing.assert_array_equal(got.lora_a.numpy(), want_a, err_msg=f"{leaf} A, shard {t}")
                np.testing.assert_array_equal(got.lora_b.numpy(), want_b, err_msg=f"{leaf} B, shard {t}")


def test_tp_forward_and_backward_with_an_adapter_equal_tp1(model_path, adapter):
    one = _port_backend(model_path, adapter)
    two = _port_backend(model_path, adapter, ["cpu"] * 2)
    hsz = one.hidden_size
    rng = np.random.RandomState(11)
    hidden = torch.from_numpy((rng.standard_normal((2, 6, hsz)) * 0.5).astype(np.float32))
    grad = torch.from_numpy(rng.standard_normal((2, 6, hsz)).astype(np.float32))
    got, want = (b.forward(hidden, active_adapter="lora-tp") for b in (two, one))
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
    assert float((two.forward(hidden) - got).abs().max()) > 1e-3  # the adapter applies
    (got, _), (want, _) = (b.backward(hidden, grad, active_adapter="lora-tp") for b in (two, one))
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)


class TpPair:
    """A port num_tp_devices=2 server and a petals_tpu one, each hosting the
    adapter on every block, a swarm of one each, with a raw RPC client."""

    def __init__(self, model_path, adapter):
        self.loop = Loop()

        async def boot():
            self.port = Server(model_path, first_block=0, num_blocks=N_LAYERS, device="cpu", num_tp_devices=2,
                               compute_dtype=torch.float32, throughput=1.0, adapters=[adapter])
            await self.port.start()
            self.jax = JaxServer(model_path, first_block=0, num_blocks=N_LAYERS, compute_dtype=jnp.float32,
                                 use_flash=False, throughput=1.0, adapters=[adapter], num_tp_devices=2)
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
def pair(model_path, adapter):
    p = TpPair(model_path, adapter)
    yield p
    p.close()


def test_tp_adapter_session_equals_petals_tpu_tp(pair, model_path):
    assert pair.port.backend.tp_size == 2 and sorted(pair.port.backend.adapters) == ["lora-tp"]
    hsz = pair.port.cfg.hidden_size
    rng = np.random.RandomState(4)
    prefill = (rng.standard_normal((1, 9, hsz)) * 0.3).astype(np.float32)
    step = (rng.standard_normal((1, 1, hsz)) * 0.3).astype(np.float32)
    open_msg = {"uids": _uids(model_path, 0, N_LAYERS), "max_length": 32, "batch_size": 1,
                "active_adapter": "lora-tp"}
    steps = [{"tensors": {"hidden": serialize_array(prefill)}},
             {"tensors": {"hidden": serialize_array(step)}},
             {"tensors": {"hidden": serialize_array(step)}, "gen_tokens": 4}]
    got, want = (pair.session(which, open_msg, steps) for which in ("port", "jax"))
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(np.asarray(deserialize_array(g["tensors"]["hidden"])),
                                   np.asarray(deserialize_array(w["tensors"]["hidden"])), rtol=FWD_TOL, atol=FWD_TOL)
    assert got[3]["tokens"] == want[3]["tokens"] and len(got[3]["tokens"]) == 4


def test_tp_forward_and_backward_over_the_wire_equal_petals_tpu_tp(pair, model_path):
    hsz = pair.port.cfg.hidden_size
    rng = np.random.RandomState(6)
    hidden = (rng.standard_normal((2, 8, hsz)) * 0.3).astype(np.float32)
    grad = (rng.standard_normal((2, 8, hsz)) * 0.3).astype(np.float32)
    fwd = {"uids": _uids(model_path, 0, N_LAYERS), "active_adapter": "lora-tp",
           "tensors": {"hidden": serialize_array(hidden)}}
    got, want = (deserialize_array(pair.call(w, "ptu.forward", fwd)["tensors"]["hidden"]) for w in ("port", "jax"))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    bwd = {**fwd, "tensors": {**fwd["tensors"], "grad_out": serialize_array(grad)}}
    got, want = (pair.call(w, "ptu.backward", bwd)["tensors"]["grad_hidden"] for w in ("port", "jax"))
    np.testing.assert_allclose(np.asarray(deserialize_array(got)), np.asarray(deserialize_array(want)),
                               rtol=0, atol=ATOL)
