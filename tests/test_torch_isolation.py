"""The port stands alone: importing every module of petals_tpu_torch loads
neither jax nor any petals_tpu module, no source line imports them, and the
entry points run on the CUDA card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import petals_tpu_torch

PACKAGE_DIR = os.path.dirname(petals_tpu_torch.__file__)
REPO_ROOT = os.path.dirname(PACKAGE_DIR)


def test_importing_every_module_loads_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import petals_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(petals_tpu_torch.__path__, "petals_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
                     or k == "petals_tpu" or k.startswith("petals_tpu."))
        client = {"petals_tpu_torch.client." + m for m in (
            "config", "runtime", "inference_session", "remote_sequential", "remote_generation",
            "from_pretrained", "model", "routing.sequence_manager", "routing.sequence_info",
            "routing.spending_policy")} | {"petals_tpu_torch.models.client_common",
            "petals_tpu_torch.models.llama.model", "petals_tpu_torch.models.qwen2",
            "petals_tpu_torch.telemetry", "petals_tpu_torch.telemetry.observatory",
            "petals_tpu_torch.ops.sampling", "petals_tpu_torch.ops.threefry"}
        assert client <= set(names), sorted(client - set(names))  # the client, telemetry and sampling are walked
        # the scheduler, the ledger, the sanitizer and locks, the relay and reachability
        swap_wire = {"petals_tpu_torch." + m for m in (
            "server.scheduler", "telemetry.ledger", "analysis.sanitizer", "utils.locks", "rpc.relay",
            "server.reachability")}
        assert swap_wire <= set(names), sorted(swap_wire - set(names))
        # the swarm operations: chaos, the autoscaler, traffic, the caches
        swarm_ops = {"petals_tpu_torch." + m for m in (
            "constants", "chaos", "chaos.plane", "swarm", "swarm.policy", "swarm.autoscaler",
            "cli.run_autoscaler", "traffic", "traffic.generator", "traffic.runner", "utils.logging",
            "utils.misc", "utils.random_utils", "utils.asyncio_utils", "utils.packaging", "utils.disk_cache",
            "utils.quant_cache", "utils.hub")}
        assert swarm_ops <= set(names), sorted(swarm_ops - set(names))
        # tensor and sequence parallelism: the devices, the splits, the
        # reduction, the sp grid and the ring; multi-host lockstep, its
        # worker and the pipeline schedule
        parallel = {"petals_tpu_torch." + m for m in (
            "parallel", "parallel.mesh", "parallel.tp", "parallel.collectives", "parallel.sp",
            "ops.ring_attention", "parallel.multihost", "parallel.pipeline", "cli.run_worker")}
        assert parallel <= set(names), sorted(parallel - set(names))
        print(len(names), bad)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 30  # every module was walked


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    sources = [
        os.path.join(root, f)
        for root, _, files in os.walk(PACKAGE_DIR) for f in files if f.endswith(".py")
    ]
    sources.append(os.path.join(REPO_ROOT, "chip_smoke.py"))
    offenders = []
    for path in sources:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "petals_tpu", "ml_dtypes", "msgpack", "safetensors", "transformers"):
                offenders.append((os.path.relpath(path, REPO_ROOT), name))
    assert not offenders, offenders


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is valid here")
    from petals_tpu_torch.server.from_pretrained import load_block_params
    from petals_tpu_torch.server.server import Server
    from petals_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(str(tmp_path), first_block=0, num_blocks=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_block_params(str(tmp_path), 0)
    # the client: its parameters go to the card unless the caller asks for the CPU
    from petals_tpu_torch.client import AutoDistributedModelForCausalLM
    from petals_tpu_torch.client.from_pretrained import load_client_params

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoDistributedModelForCausalLM.from_pretrained(str(tmp_path), initial_peers=[])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_client_params(str(tmp_path))


def test_flash_attention_never_falls_back_off_the_cpu():
    """``flash_attend`` takes its plain version only for tensors on the CPU:
    tensors elsewhere reach the kernel path or raise (here: a meta tensor, the
    nearest thing to a CUDA tensor on a machine without a card), and a CUDA
    launch without a card cannot build or load the kernel."""
    from petals_tpu_torch.ops import flash_attention as fa
    from petals_tpu_torch.ops.attention import attend

    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 16, 2, 64)
    assert fa.flash_attend(q, k, k).shape == q.shape  # the CPU: the plain version
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attend(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        attend(q.to("meta"), k.to("meta"), k.to("meta"), use_flash=True)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attend(q, k.to("meta"), k.to("meta"))  # mixed devices
    if not torch.cuda.is_available():
        with pytest.raises(Exception):  # no nvcc, no card: the build or the load fails loudly
            fa.kernel_library()


@pytest.mark.parametrize("module", [
    "petals_tpu_torch.ops.flash_attention",
    "petals_tpu_torch.ops.attention",
    "petals_tpu_torch.models.common",
    "petals_tpu_torch.server.backend",
    "petals_tpu_torch.server.batching",
    "petals_tpu_torch.server.handler",
    "petals_tpu_torch.server.server",
    "petals_tpu_torch.utils.convert",
    "petals_tpu_torch.telemetry.observatory",
    "petals_tpu_torch.server.scheduler",
    "petals_tpu_torch.telemetry.ledger",
    "petals_tpu_torch.analysis.sanitizer",
    "petals_tpu_torch.utils.locks",
    "petals_tpu_torch.rpc.relay",
    "petals_tpu_torch.server.reachability",
])
def test_dense_cache_modules_import_without_jax(module):
    """Each module that serves dense caches, imported alone in a fresh
    interpreter, loads neither jax nor the JAX package, and builds no kernel
    at import."""
    code = (
        f"import importlib, sys; importlib.import_module({module!r}); "
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'petals_tpu')]; "
        "assert not bad, bad; "
        "from petals_tpu_torch.ops import flash_attention as fa; assert fa._LIB is None"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
