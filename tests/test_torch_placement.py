"""Placement, sizing and throughput of the port against petals_tpu's:

- ``compute_throughputs`` / ``choose_best_start`` give petals_tpu's answers
  on seeded random swarms (ONLINE / JOINING / OFFLINE mixes, holes, an
  excluded peer): exact, the same float sums in the same order;
- ``block_params_count`` and ``choose_num_blocks`` equal petals_tpu's for
  every quant_type at given memory limits (tiny-llama and a Mistral-7B
  config);
- ``get_server_throughput`` blends compute and network and caches the
  compute figures as petals_tpu's does, with the measurement stubbed in
  both and the caches under tmp_path; the port's cache is its own file;
- ``TransformerBackend.forward`` (stateless, no KV cache) equals the JAX
  backend's ``forward`` on tiny-llama and tiny-mistral (its sliding window)
  in float32, with and without deep prompts, at a decode-sized and a
  flash-sized chunk, within atol 2e-5 (tests/test_torch_backend.py's).
- the throughput probe itself runs through the port's backend on the CPU,
  paged and dense, and gives positive rates."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu import data_structures as jds
from petals_tpu.server import block_selection as jsel
from petals_tpu.server import block_utils as jutils
from petals_tpu.server import throughput as jthroughput
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch import data_structures as pds
from petals_tpu_torch.server import block_selection as psel
from petals_tpu_torch.server import block_utils as putils
from petals_tpu_torch.server import throughput as pthroughput
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config
from petals_tpu_torch.utils.convert import stacked_from_numpy
from tests.utils import make_tiny_llama, make_tiny_mistral

pytestmark = pytest.mark.timeout(300)

TOL = 2e-5
N_BLOCKS = 2
QUANT_TYPES = ["none", "int8", "nf4", "nf4a", "int4", "nf4a+o", "int4+o"]
MISTRAL_7B = {
    "model_type": "mistral", "architectures": ["MistralForCausalLM"],
    "hidden_size": 4096, "intermediate_size": 14336, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "num_hidden_layers": 32,
    "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "sliding_window": 4096,
    "vocab_size": 32000, "hidden_act": "silu", "max_position_embeddings": 32768,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}


def _random_swarm(rng, n_blocks, n_peers):
    """The same swarm as petals_tpu's and the port's RemoteModuleInfo lists."""
    peers = [bytes(rng.randint(0, 256, 32).astype(np.uint8)) for _ in range(n_peers)]
    spans = []
    for raw in peers:
        start = int(rng.randint(0, n_blocks))
        end = int(rng.randint(start + 1, n_blocks + 1))
        spans.append((raw, start, end, int(rng.randint(0, 3)), float(rng.uniform(0.5, 100.0))))
    out = {}
    for mod in (jds, pds):
        infos = []
        for b in range(n_blocks):
            servers = {
                mod.PeerID(raw): mod.ServerInfo(state=mod.ServerState(state), throughput=tp)
                for raw, start, end, state, tp in spans if start <= b < end
            }
            infos.append(mod.RemoteModuleInfo(uid=f"m.{b}", servers=servers) if servers else None)
        out[mod] = infos
    return peers, out[jds], out[pds]


@pytest.mark.parametrize("seed", range(6))
def test_placement_equals_petals_tpu(seed):
    rng = np.random.RandomState(seed)
    n_blocks = int(rng.randint(4, 40))
    peers, jinfos, pinfos = _random_swarm(rng, n_blocks, int(rng.randint(1, 9)))
    for exclude in (None, peers[0]):
        jt = jsel.compute_throughputs(jinfos, exclude_peer=exclude and jds.PeerID(exclude))
        pt = psel.compute_throughputs(pinfos, exclude_peer=exclude and pds.PeerID(exclude))
        np.testing.assert_array_equal(jt, pt)
        for num_blocks in range(1, n_blocks + 1):
            assert jsel.choose_best_start(jt, num_blocks) == psel.choose_best_start(pt, num_blocks)


def test_placement_ties_and_empty_swarm():
    for mod_sel in (jsel, psel):
        assert mod_sel.choose_best_start(np.zeros(8), 3) == 0
        assert mod_sel.choose_best_start(np.array([1.0, 1.0, 0.0, 0.0, 1.0]), 2) == 2
        assert mod_sel.choose_best_start(np.array([2.0, 1.0, 1.0, 2.0]), 4) == 0


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    tiny = make_tiny_llama(str(tmp_path_factory.mktemp("models")), n_layers=4)
    mistral = tmp_path_factory.mktemp("mistral-7b")
    (mistral / "config.json").write_text(json.dumps(MISTRAL_7B))
    return {"tiny-llama": tiny, "mistral-7b": str(mistral)}


@pytest.mark.parametrize("model", ["tiny-llama", "mistral-7b"])
@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_choose_num_blocks_equals_petals_tpu(configs, model, quant_type):
    path = configs[model]
    jfamily, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    assert putils.block_params_count(family, cfg) == jutils.block_params_count(jfamily, jcfg)
    assert putils.estimated_block_size_bytes(family, cfg, quant_type) == jutils.estimated_block_size_bytes(
        jfamily, jcfg, quant_type
    )
    block = putils.estimated_block_size_bytes(family, cfg, quant_type)
    for memory in (block, 5 * block + 7, 80 * 2**30, 10**15):
        for attn_cache_bytes in (0, 2**20, 2 * 8192 * 8 * 128 * 2 * 32):
            kwargs = dict(quant_type=quant_type, attn_cache_bytes=attn_cache_bytes, memory_limit_bytes=memory)
            assert putils.choose_num_blocks(family, cfg, **kwargs) == jutils.choose_num_blocks(jfamily, jcfg, **kwargs)


def test_get_server_throughput_blends_and_caches_as_petals_tpu(configs, tmp_path, monkeypatch):
    path = configs["tiny-llama"]
    jfamily, jcfg = jax_block_config(path)
    family, cfg = get_block_config(path)
    calls = {"jax": 0, "port": 0}

    def stub(kind):
        def measure(*args, **kwargs):
            calls[kind] += 1
            return {"inference_rps": 321.0, "forward_rps": 9000.0}
        return measure

    monkeypatch.setattr(jthroughput, "measure_compute_rps", stub("jax"))
    monkeypatch.setattr(pthroughput, "measure_compute_rps", stub("port"))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    # no relay: the port has none, so its blend is petals_tpu's direct one
    for network_mbps, num_blocks in ((100.0, 3), (1.0, 1), (50.0, 2)):
        want = jthroughput.get_server_throughput(
            jfamily, jcfg, compute_dtype=jnp.float32, network_mbps=network_mbps, num_blocks=num_blocks,
            cache_dir=jdir,
        )
        got = pthroughput.get_server_throughput(
            family, cfg, device="cpu", compute_dtype=torch.float32, network_mbps=network_mbps,
            num_blocks=num_blocks, cache_dir=pdir,
        )
        assert got == want
    assert calls == {"jax": 1, "port": 1}  # measured once, then read from the cache
    pthroughput.get_server_throughput(family, cfg, device="cpu", compute_dtype=torch.float32, network_mbps=1.0,
                                      cache_dir=tmp_path / "fresh")  # a fresh cache measures again
    pthroughput.get_server_throughput(family, cfg, device="cpu", compute_dtype=torch.float32, network_mbps=1.0,
                                      cache_dir=pdir, page_size=0)  # another decode path: another key
    assert calls["port"] == 3
    cache = json.loads((pdir / pthroughput.THROUGHPUT_FILE).read_text())
    keys = [json.loads(k) for k in cache]
    assert sorted(k["decode"] for k in keys) == ["dense", "paged:64:none"]
    assert all(k["backend"] == "cpu" and k["version"] == "0.1.0" and k["dtype"] == "float32" for k in keys)
    assert not (pdir / jthroughput.THROUGHPUT_FILE).exists() and not (jdir / pthroughput.THROUGHPUT_FILE).exists()


@pytest.mark.parametrize("page_size", [16, 0])
def test_measure_compute_rps_runs_the_port_backend(configs, page_size):
    family, cfg = get_block_config(configs["tiny-llama"])
    rps = pthroughput.measure_compute_rps(
        family, cfg, device="cpu", compute_dtype=torch.float32, page_size=page_size,
        n_steps_inference=3, n_steps_forward=1,
    )
    assert rps["inference_rps"] > 0 and rps["forward_rps"] > 0
    assert pthroughput.measure_network_rps(cfg.hidden_size) > 0


@pytest.fixture(scope="module", params=["llama", "mistral"])
def forward_backends(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fwd"))
    path = make_tiny_llama(root, n_layers=N_BLOCKS) if request.param == "llama" else make_tiny_mistral(
        root, n_layers=N_BLOCKS, window=6
    )
    jfamily, jcfg = jax_block_config(path)
    per_block = [jax_load_block(path, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(N_BLOCKS)]
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_block)
    jax_backend = JaxBackend(
        jfamily, jcfg, jstacked, first_block=0, n_blocks=N_BLOCKS,
        memory_cache=JaxMemoryCache(None), compute_dtype=jnp.float32, use_flash=False,
    )
    family, cfg = get_block_config(path)
    numpy_blocks = [jax.tree_util.tree_map(np.asarray, p) for p in per_block]
    backend = TransformerBackend(
        family, cfg, stacked_from_numpy(numpy_blocks, "cpu", torch.float32),
        first_block=0, n_blocks=N_BLOCKS, device="cpu", compute_dtype=torch.float32,
    )
    return jax_backend, backend, cfg


@pytest.mark.parametrize("seq", [5, 24])
@pytest.mark.parametrize("with_prompts", [False, True])
def test_forward_equals_jax_backend(forward_backends, seq, with_prompts):
    jax_backend, backend, cfg = forward_backends
    rng = np.random.RandomState(seq + 10 * with_prompts)
    hidden = rng.standard_normal((2, seq, cfg.hidden_size)).astype(np.float32)
    prompts = None
    if with_prompts:
        prompts = (rng.standard_normal((N_BLOCKS, 2, 3, cfg.hidden_size)) * 0.5).astype(np.float32)
    want = np.asarray(jax_backend.forward(hidden, prompts=prompts))
    got = backend.forward(torch.from_numpy(hidden), prompts=None if prompts is None else torch.from_numpy(prompts))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
