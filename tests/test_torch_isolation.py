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
