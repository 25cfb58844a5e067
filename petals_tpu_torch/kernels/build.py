"""Build the package's CUDA sources into shared libraries with a plain C
interface and load them with ctypes.

``nvcc`` compiles each ``csrc/<name>.cu`` for ``sm_90a`` on first use. The
library lands in ``build/kernels/`` beside the package (a directory the
repository's ``.gitignore`` lists), under a name keyed by a hash of the source,
the headers beside it and the compiler flags, so an edited source or header
rebuilds and an unchanged one is reused. Nothing is compiled at import: the
CPU tests import every module on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def nvcc_command(source, output) -> list:
    """The nvcc command that builds ``source`` (a ``.cu`` file anywhere, e.g.
    a modified copy) into the shared library ``output``; csrc's headers are
    on the include path."""
    return [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(output), str(source)]


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed by the
    source, every header beside it (``csrc/*.cuh``, which a source may
    include) and the flags, so an edited header rebuilds too."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists; returns
    its path. The compiler's report (registers, shared memory, spills) is kept
    beside it as ``<library>.log``. Safe against concurrent builds: they
    serialize on a lock file and the library appears atomically."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = nvcc_command(CSRC_DIR / f"{name}.cu", tmp)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {name}.cu:\n{proc.stdout}{proc.stderr}"
            )
        Path(f"{out}.log").write_text(
            f"{' '.join(cmd)}\nbuilt in {time.perf_counter() - t0:.1f}s\n{proc.stdout}{proc.stderr}"
        )
        os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``csrc/<name>.cu``'s library."""
    return ctypes.CDLL(str(build(name)))
