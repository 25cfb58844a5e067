"""(e) Sequence parallelism across processes: sp=2 over a port leader and a
port worker (tests/torch_multihost_child.py, gloo, one sp rank a process),
so the ring's K/V blocks, their gradients and the cached prefill's K/V rows
cross the process boundary. The ring's forward (8 rows, 4 a process) and
backward, a query-sharded cached prefill, a decode step and the cache read
back are held to petals_tpu's one-process backend on a CPU ("tp", "sp")
serving mesh within float32's 2e-5; the ring's forward and the cached path
are bit-equal to the port's one-process sp=2 backend. The two processes
fold n * n = 4 K/V blocks a block call between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.parallel.mesh import serving_mesh
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from tests.test_torch_multihost import TOL, run_group
from tests.torch_multihost_child import inputs
from tests.utils import make_tiny_llama


def _sequence(b, x, zeros, read):
    res = {"fwd": b.forward(x["fwd"])}
    res["g_in"], _ = b.backward(x["fwd"], x["grad"])
    kv = zeros()
    res["prefill"], kv2 = b.inference_step(x["long"], kv, 0)
    kv = kv2 if kv2 is not None else kv
    res["decode"], kv2 = b.inference_step(x["step"][:1], kv, 8)
    kv = kv2 if kv2 is not None else kv
    res["k"], res["v"] = (read(t) for t in kv)
    return res


def jax_reference(model: str) -> dict:
    jfamily, jcfg = jax_block_config(model)
    n = jcfg.num_hidden_layers
    blocks = [jax_load_block(model, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(n)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)
    b = JaxBackend(jfamily, jcfg, stacked, first_block=0, n_blocks=n, memory_cache=JaxMemoryCache(None),
                   compute_dtype=jnp.float32, use_flash=False, mesh=serving_mesh(1, 2))
    res = _sequence(b, inputs(jcfg.hidden_size, n),
                    lambda: tuple(d.make_zeros() for d in b.cache_descriptors(1, 32, 0, n)),
                    lambda t: np.asarray(t)[:, :, :9])
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def port_reference(model: str) -> dict:
    family, cfg = get_block_config(model)
    n = cfg.num_hidden_layers
    blocks = [load_block_params(model, i, dtype=torch.float32, device="cpu", family=family, cfg=cfg) for i in range(n)]
    b = TransformerBackend(family, cfg, blocks, first_block=0, n_blocks=n, device="cpu", compute_dtype=torch.float32,
                           use_flash=False, tp_devices=["cpu"] * 2, num_sp_devices=2)
    x = {k: torch.from_numpy(v) for k, v in inputs(cfg.hidden_size, n).items()}
    res = _sequence(b, x, lambda: tuple(d.make_zeros() for d in b.cache_descriptors(1, 32, 0, n)),
                    lambda t: t[:, :, :9].cpu())
    return {k: v.detach().float().numpy() for k, v in res.items()}


@pytest.mark.timeout(240)
def test_sp2_across_processes_matches_jax_and_one_process(tmp_path):
    model = make_tiny_llama(str(tmp_path / "models"))
    run = run_group(tmp_path, "sp", model, 2, 1, 2)
    assert run["codes"] == [0, 0]
    got = run["out"]
    _, all_gathers, rings = got.pop("crossings")
    assert rings > 0 and all_gathers > 0  # K/V blocks went round the ring; rows were gathered
    folds = int(got.pop("folds"))
    worker_folds = int(next(ln.split()[1] for ln in run["logs"].splitlines() if ln.startswith("WORKER_FOLDS")))
    n_blocks = 4
    # the ring's forward, and the backward's recompute and gradient pass: n * n folds a block call together
    assert folds == worker_folds and folds + worker_folds == 4 * n_blocks * 3
    for name, w in jax_reference(model).items():
        np.testing.assert_allclose(got[name], w, atol=TOL, rtol=0, err_msg=f"{name} vs JAX sp=2")
    port = port_reference(model)
    for name in ("fwd", "prefill", "decode", "k", "v"):
        np.testing.assert_array_equal(got[name], port[name], err_msg=f"{name} vs the port's one-process sp=2")
    np.testing.assert_allclose(got["g_in"], port["g_in"], atol=TOL, rtol=0)
