"""Multi-host lockstep serving in the port (petals_tpu_torch/parallel/
multihost.py) against the JAX package on the CPU, float32: a port leader
and port workers as subprocesses (tests/torch_multihost_child.py) over
``torch.distributed`` with gloo, each process holding its entries of the
tp grid on the CPU, so every tp collective crosses a process boundary.

- (a) The lockstep core at tp=2 (one shard a process) and tp=4 (two a
  process): ALLOC, steps with prompts and hypo_ids, KV export and an import
  into a fresh mirror, FORWARD, BACKWARD (with deep prompts), a lane's
  check-out and prefill and check-in, the batched decode and a pooled
  lane's snapshot, and the same on a one-lane pool (its lane's view has the
  pool's address and shape) with a batched decode after the snapshot. Every output is held to petals_tpu's one-process
  ``TransformerBackend`` on a CPU tp mesh within float32's 2e-5, and at one
  shard a process bit-equal to the port's one-process tp=2 backend.
- A LoRA adapter crosses as its index into the sorted names with their
  digest: at tp=2 its session, forward and backward are bit-equal to the
  one-process tp=2 backend's; a worker with another adapter set stops,
  and the leader degrades.
- (b) A killed worker makes the leader's next op raise
  ``MultihostDegraded`` within the group's timeout; later ops fail fast,
  and the leader lives on.
- The layout's refusals (too few devices, a grid that does not split over
  the processes) and the adapter digest's bytes.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.parallel.mesh import make_mesh
from petals_tpu.parallel.multihost import _adapter_digest as jax_digest
from petals_tpu.server.backend import TransformerBackend as JaxBackend
from petals_tpu.server.from_pretrained import get_block_config as jax_block_config
from petals_tpu.server.from_pretrained import load_block_params as jax_load_block
from petals_tpu.server.memory_cache import MemoryCache as JaxMemoryCache
from petals_tpu_torch.parallel import multihost as mh
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from tests.torch_multihost_child import inputs
from tests.utils import make_tiny_llama

TOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the group timeout's test hook: a dead member fails an op within 20 s
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", PETALS_TPU_MULTIHOST_TIMEOUT="20")
    return env


def kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=30)


def spawn(args, log_path, env=None):
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env or child_env(), stdout=open(log_path, "w"),
                            stderr=subprocess.STDOUT)


def run_group(tmp_path, role: str, model: str, world: int, tp: int, sp: int, timeout: float = 150,
              adapters=("", "")) -> dict:
    """One leader (``role``) and ``world - 1`` workers of
    tests/torch_multihost_child.py (``adapters``: the leader's and the
    workers' ``$MH_ADAPTERS``); the leader must exit 0. Returns its outputs,
    the logs and every process's exit code."""
    coord = f"127.0.0.1:{free_port()}"
    out = str(tmp_path / f"{role}.npz")
    mod = ["-m", "tests.torch_multihost_child"]
    procs = []
    try:
        procs.append(spawn([*mod, role, model, coord, str(world), "0", str(tp), str(sp), out], tmp_path / "leader.log",
                           dict(child_env(), MH_ADAPTERS=adapters[0])))
        for r in range(1, world):
            procs.append(spawn([*mod, "worker", model, coord, str(world), str(r), str(tp), str(sp), "-"],
                               tmp_path / f"worker{r}.log", dict(child_env(), MH_ADAPTERS=adapters[1])))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        logs = "\n".join((tmp_path / f).read_text() for f in os.listdir(tmp_path) if f.endswith(".log"))
        assert procs[0].returncode == 0, logs[-4000:]
        return {"out": dict(np.load(out)), "logs": logs, "codes": [p.returncode for p in procs]}
    finally:
        kill_all(procs)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh_models")
    return {"kv2": make_tiny_llama(str(root)), "kv4": make_tiny_llama(str(root / "kv4"), kv_heads=4)}


# ---------------------------------------------------------------------------- references


def jax_reference(model: str, tp: int) -> dict:
    """The child's op sequence on petals_tpu's one-process backend over a
    CPU ("tp",) mesh."""
    jfamily, jcfg = jax_block_config(model)
    n = jcfg.num_hidden_layers
    blocks = [jax_load_block(model, i, dtype=jnp.float32, family=jfamily, cfg=jcfg) for i in range(n)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)
    b = JaxBackend(jfamily, jcfg, stacked, first_block=0, n_blocks=n, memory_cache=JaxMemoryCache(None),
                   compute_dtype=jnp.float32, use_flash=False, mesh=make_mesh((tp,), ("tp",)))
    x = inputs(jcfg.hidden_size, n)
    zeros = lambda batch: tuple(d.make_zeros() for d in b.cache_descriptors(batch, 32, 0, n))  # noqa: E731
    res = {}
    kv = zeros(2)
    res["out1"], kv = b.inference_step(x["prefill"], kv, 0)
    res["out2"], kv = b.inference_step(x["step"], kv, 6)
    res["out3"], kv = b.inference_step(x["step"], kv, 7, prompts=x["prompts"])
    res["out4"], kv = b.inference_step(x["step"], kv, 8, hypo_ids=x["hypo"])
    res["k"], res["v"] = (np.asarray(t)[:, :, :9] for t in kv)
    res["imported"], _ = b.inference_step(x["step"], kv, 9)
    res["fwd"] = b.forward(x["fwd"])
    res["g_in"], res["g_prompts"] = b.backward(x["fwd"], x["grad"], prompts=x["prompts"])
    k_pool, v_pool = zeros(3)
    lane = b._lane_extract_fn(k_pool, v_pool, np.int32(1))
    res["lane_prefill"], lane = b.inference_step(x["lane_prefill"], lane, 0)
    pool = b._lane_insert_fn(k_pool, v_pool, *lane, np.int32(1))
    res["decode"], pool = b.batched_decode_step(x["lanes"], pool, np.array([0, 4, 0], np.int32))
    res["lane_k"], res["lane_v"] = (np.asarray(t)[:, 1:2, :5] for t in pool)
    k_one, v_one = zeros(1)
    lane = b._lane_extract_fn(k_one, v_one, np.int32(0))
    res["one_prefill"], lane = b.inference_step(x["lane_prefill"], lane, 0)
    one = b._lane_insert_fn(k_one, v_one, *lane, np.int32(0))
    res["one_decode1"], one = b.batched_decode_step(x["lanes"][:1], one, np.array([4], np.int32))
    res["one_k"], res["one_v"] = (np.asarray(t)[:, :, :5] for t in one)
    res["one_decode2"], one = b.batched_decode_step(x["lanes"][1:2], one, np.array([5], np.int32))
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def port_reference(model: str, tp: int) -> dict:
    """The same sequence on the port's one-process tp backend (plain caches,
    a lane view written in place)."""
    family, cfg = get_block_config(model)
    n = cfg.num_hidden_layers
    blocks = [load_block_params(model, i, dtype=torch.float32, device="cpu", family=family, cfg=cfg) for i in range(n)]
    b = TransformerBackend(family, cfg, blocks, first_block=0, n_blocks=n, device="cpu", compute_dtype=torch.float32,
                           use_flash=False, tp_devices=["cpu"] * tp)
    x = {k: torch.from_numpy(v) for k, v in inputs(cfg.hidden_size, n).items()}
    zeros = lambda batch: tuple(d.make_zeros() for d in b.cache_descriptors(batch, 32, 0, n))  # noqa: E731
    res = {}
    kv = zeros(2)
    res["out1"], _ = b.inference_step(x["prefill"], kv, 0)
    res["out2"], _ = b.inference_step(x["step"], kv, 6)
    res["out3"], _ = b.inference_step(x["step"], kv, 7, prompts=x["prompts"])
    res["out4"], _ = b.inference_step(x["step"], kv, 8, hypo_ids=x["hypo"])
    res["k"], res["v"] = (t[:, :, :9].cpu() for t in kv)
    kv2 = zeros(2)
    b.seed_cache(kv2, res["k"], res["v"])
    res["imported"], _ = b.inference_step(x["step"], kv2, 9)
    res["fwd"] = b.forward(x["fwd"])
    res["g_in"], res["g_prompts"] = b.backward(x["fwd"], x["grad"], prompts=x["prompts"])
    pool = zeros(3)
    lane = b.dense_lane_view(*pool, 1)
    res["lane_prefill"], _ = b.inference_step(x["lane_prefill"], lane, 0)
    res["decode"], _ = b.batched_decode_step(x["lanes"], pool, np.array([0, 4, 0], np.int32))
    res["lane_k"], res["lane_v"] = (t[:, 1:2, :5].cpu() for t in pool)
    one = zeros(1)
    res["one_prefill"], _ = b.inference_step(x["lane_prefill"], b.dense_lane_view(*one, 0), 0)
    res["one_decode1"], _ = b.batched_decode_step(x["lanes"][:1], one, np.array([4], np.int32))
    res["one_k"], res["one_v"] = (t[:, :, :5].cpu() for t in one)
    res["one_decode2"], _ = b.batched_decode_step(x["lanes"][1:2], one, np.array([5], np.int32))
    return {k: v.detach().float().numpy() for k, v in res.items()}


# ---------------------------------------------------------------------------- (a) the lockstep core


@pytest.mark.timeout(240)
@pytest.mark.parametrize("tp,world,model", [(2, 2, "kv2"), (4, 2, "kv4")], ids=["tp2-one-shard-a-process",
                                                                             "tp4-two-shards-a-process"])
def test_lockstep_core_matches_jax_and_one_process(tmp_path, models, tp, world, model):
    run = run_group(tmp_path, "core", models[model], world, tp, 1)
    assert run["codes"] == [0] * world
    got = run["out"]
    all_reduces, _, _ = got.pop("crossings")
    assert all_reduces > 0  # the shards' sums crossed the process boundary
    want = jax_reference(models[model], tp)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=TOL, rtol=0, err_msg=f"{name} vs JAX tp={tp}")
    if tp == world:  # one shard a process: the sums are the one-process sums, bit for bit
        for name, w in port_reference(models[model], tp).items():
            np.testing.assert_array_equal(got[name], w, err_msg=f"{name} vs the port's one-process tp={tp}")


# ---------------------------------------------------------------------------- adapters


@pytest.mark.timeout(240)
def test_adapter_crosses_as_its_index_and_a_drifted_set_is_refused(tmp_path, models):
    """tp=2 with a LoRA adapter on both processes: its session, forward and
    backward bit-equal to the port's one-process tp=2 backend with the
    adapter (the adapter changes the output); an unknown name refused
    before any broadcast. A worker hosting no adapter refuses the leader's
    index by its digest: the worker stops and the leader degrades."""
    from tests.test_torch_backward import make_adapter
    from tests.torch_multihost_child import install_adapters

    model = models["kv2"]
    path = make_adapter(str(tmp_path / "adapters"), model, name="lora-tp", seed=3, rank=4,
                        targets=("self_attn.q_proj", "self_attn.v_proj", "self_attn.o_proj", "mlp.down_proj"))
    (tmp_path / "ok").mkdir()
    run = run_group(tmp_path / "ok", "adapter", model, 2, 2, 1, adapters=(path, path))
    assert run["codes"] == [0, 0]
    got = run["out"]
    assert int(got["unknown_refused"]) == 1 and "mismatch" not in got
    family, cfg = get_block_config(model)
    blocks = [load_block_params(model, i, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
              for i in range(cfg.num_hidden_layers)]
    b = TransformerBackend(family, cfg, blocks, first_block=0, n_blocks=len(blocks), device="cpu",
                           compute_dtype=torch.float32, use_flash=False, tp_devices=["cpu"] * 2)
    install_adapters(b, path)
    x = {k: torch.from_numpy(v) for k, v in inputs(cfg.hidden_size, len(blocks)).items()}
    kv = tuple(d.make_zeros() for d in b.cache_descriptors(2, 32, 0, len(blocks)))
    want = {"out1": b.inference_step(x["prefill"], kv, 0, active_adapter="lora-tp")[0],
            "out2": b.inference_step(x["step"], kv, 6, active_adapter="lora-tp")[0],
            "fwd": b.forward(x["fwd"], active_adapter="lora-tp"),
            "g_in": b.backward(x["fwd"], x["grad"], active_adapter="lora-tp")[0]}
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.detach().numpy(), err_msg=name)
    assert np.abs(got["fwd"] - got["plain"]).max() > 1e-3  # the adapter applied
    (tmp_path / "drift").mkdir()
    run = run_group(tmp_path / "drift", "adapter", model, 2, 2, 1, adapters=(path, ""))
    assert int(run["out"]["mismatch"]) == 1 and run["codes"][1] != 0
    assert "must be started with identical --adapters flags" in run["logs"]


# ---------------------------------------------------------------------------- (b) a dead worker

_DEATH = r"""
import sys, time
import numpy as np, torch
from petals_tpu_torch.parallel import multihost as mh
from tests import torch_multihost_child as child

child.COORD = sys.argv[2]
backend = child.build(sys.argv[1], 2, 0, 2, 1)
lb = mh.LockstepBackend(backend)
x = torch.from_numpy(child.inputs(backend.hidden_size, backend.n_blocks)["fwd"])
lb.forward(x)
print("FIRST_OK", flush=True)
sys.stdin.readline()  # the test kills the worker, then writes a line
t0 = time.monotonic()
try:
    lb.forward(x)
    print("NO_ERROR", flush=True)
except mh.MultihostDegraded as e:
    print(f"DEGRADED {time.monotonic() - t0:.2f} {e!r}"[:300], flush=True)
t0 = time.monotonic()
try:
    lb.forward(x)
except mh.MultihostDegraded:
    print(f"FAST {time.monotonic() - t0:.3f}", flush=True)
lb.release_temp(-2)  # a no-op on a degraded group
print("ALIVE", flush=True)
"""


@pytest.mark.timeout(180)
def test_killed_worker_degrades_the_leader_fast(tmp_path, models):
    coord = f"127.0.0.1:{free_port()}"
    leader = subprocess.Popen([sys.executable, "-c", _DEATH, models["kv2"], coord], cwd=REPO, env=child_env(),
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    worker = spawn(["-m", "tests.torch_multihost_child", "worker", models["kv2"], coord, "2", "1", "2", "1", "-"],
                   tmp_path / "worker.log")
    try:
        lines = []
        for line in leader.stdout:
            lines.append(line)
            if line.startswith("FIRST_OK"):
                break
        assert lines and lines[-1].startswith("FIRST_OK"), "".join(lines)
        worker.send_signal(signal.SIGKILL)
        worker.wait(timeout=30)
        leader.stdin.write("go\n")
        leader.stdin.flush()
        out, _ = leader.communicate(timeout=120)
        assert leader.returncode == 0, out
        degraded = [ln for ln in out.splitlines() if ln.startswith("DEGRADED")]
        assert degraded, out
        assert float(degraded[0].split()[1]) <= 20.0 + 5.0  # within the group's timeout
        fast = [ln for ln in out.splitlines() if ln.startswith("FAST")]
        assert fast and float(fast[0].split()[1]) < 1.0, out
        assert "ALIVE" in out
    finally:
        kill_all([leader, worker])


# ---------------------------------------------------------------------------- refusals and bytes


def test_adapter_digest_has_the_jax_bytes():
    for names in ([], ["a"], ["lora-b", "lora-a"], ["x" * 40, "y"]):
        assert mh._adapter_digest(names) == jax_digest(names)


_LAYOUT = r"""
import sys
from petals_tpu_torch.parallel import multihost as mh
world, rank, per, tp, sp = map(int, sys.argv[2:7])
mh.init_multihost(sys.argv[1], world, rank, devices=["cpu"] * per, timeout=20)
try:
    lay, local = mh.multihost_layout(None if tp < 0 else tp, sp)
    print("LAYOUT", lay.t0, lay.n_t, lay.s0, lay.n_s, lay.tp, lay.sp, len(local), flush=True)
except ValueError as e:
    print("REFUSED", e, flush=True)
mh.shutdown_multihost()
"""


@pytest.mark.timeout(120)
@pytest.mark.parametrize("per,tp,sp,want", [
    (1, 3, 1, "REFUSED multihost mesh tp=3 x sp=1 needs 3 devices (tp >= 1), 2 available across 2 processes"),
    (1, -1, 3, "REFUSED multihost mesh sp=3 needs at least 3 devices, 2 available across 2 processes"),
    (3, 3, 1, "REFUSED multihost grid tp=3 x sp=1 does not split over 2 processes"),
    (2, -1, 1, "LAYOUT {t0} 2 0 1 4 1 2"),  # tp from every device: whole rows
    (2, 2, 2, "LAYOUT {t0} 1 0 2 2 2 2"),
    (1, 1, 2, "LAYOUT 0 1 {r} 1 1 2 1"),  # a run of one row's ranks
])
def test_layout_and_its_refusals(tmp_path, per, tp, sp, want):
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _LAYOUT, coord, "2", str(r), str(per), str(tp), str(sp)],
                              cwd=REPO, env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        kill_all(procs)
    for r, out in enumerate(outs):
        line = next((ln for ln in out.splitlines() if ln.startswith(("LAYOUT", "REFUSED"))), out)
        assert line.startswith(want.format(t0=2 * r if tp < 0 else r, r=r)), out
