"""Disk cache for quantized block weights (petals_tpu/utils/quant_cache.py).

Quantized leaves are a pure function of (checkpoint bytes, quant kind, fuse
flag), so a server quantizes each block once and keeps the packed codes and
scales under the shared disk cache (utils/disk_cache.py); a restart then
reads packed bytes instead of loading, fusing and encoding the block again.

The layout is petals_tpu's, byte for byte, so an entry either package wrote
serves the other: each entry is a TOP-LEVEL cache directory
``quantized--<model>--<revision>--<fingerprint>--<kind>--<block>`` holding
one ``block.npz``, which ``free_disk_space_for`` ranks and evicts as a peer
of the Hub's checkpoints (``exclude=`` protects the entry being written),
and a hit refreshes its rank by touching the directory.

npz contents: every leaf of the converted block. bfloat16 arrays are stored
bitcast to uint16 (npz has no bfloat16; numpy alone writes and reads them).
A QuantizedLinear leaf becomes two array entries (``q:<name>:data``,
``q:<name>:scales``), an outlier leaf two more (``o:<name>:idx``,
``o:<name>:w``); dense leaves are ``d:<name>``; dtypes, shapes and kinds
live in a JSON ``__manifest__`` entry. The checkpoint's fingerprint is part
of the entry's name, so a changed local checkpoint never serves stale
quantizations. A host-int leaf (gemma2's window) is stored as a 0-d integer
array and comes back as an int.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from petals_tpu_torch.ops.quant import OutlierQuantLinear, QuantizedLinear
from petals_tpu_torch.utils.disk_cache import (
    DEFAULT_CACHE_DIR,
    free_disk_space_for,
    lock_cache_dir,
)
from petals_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_PREFIX = "quantized--"
# storage-layout version, part of every entry name (petals_tpu's: the port
# keeps the JAX package's layout, int8 rows padded to its k-tile), so an
# entry of another layout is a miss, never a shape mismatch in the span
_FORMAT = "f2"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "--", str(name))


def checkpoint_fingerprint(model_name_or_path: str, revision: str = "main") -> str:
    """Cheap content stamp. For a local checkpoint directory: sha1 over the
    (name, size, mtime_ns) of its weight/index files, so editing the
    checkpoint invalidates cached quantizations. For hub repo ids the
    (repo, revision) pair is the identity (matching utils/hub.py's layout)."""
    p = Path(model_name_or_path)
    h = hashlib.sha1()
    h.update(f"{model_name_or_path}@{revision}".encode())
    if p.is_dir():
        for f in sorted(p.glob("*")):
            if f.suffix in (".safetensors", ".bin", ".json"):
                st = f.stat()
                h.update(f"{f.name}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def cache_path(
    model_name_or_path: str,
    block_index: int,
    quant_type: str,
    *,
    fuse: bool,
    revision: str = "main",
    cache_dir: Optional[Path] = None,
    dtype_tag: str = "bf16",  # dtype of the DENSE residue leaves (norms/biases)
) -> Path:
    """Path of the entry's npz; its parent directory is the LRU eviction unit."""
    base = Path(cache_dir or DEFAULT_CACHE_DIR)
    fp = checkpoint_fingerprint(model_name_or_path, revision)
    unit = (
        f"{_PREFIX}{_sanitize(model_name_or_path)}--{_sanitize(revision)}--{fp}"
        f"--{quant_type}{'-fused' if fuse else ''}-{dtype_tag}-{_FORMAT}--block{block_index}"
    )
    return base / unit / "block.npz"


def _to_numpy(arr) -> tuple[np.ndarray, str]:
    """Return (storable array, dtype tag). bfloat16 bitcasts to uint16."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bf16"
        a = t.numpy()
    else:
        a = np.asarray(arr)
    return a, a.dtype.name


def _from_numpy(a: np.ndarray, tag: str, device):
    if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
        return int(a)  # a host-int leaf
    a = np.ascontiguousarray(a)
    if tag == "bf16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def save_quantized_block(
    path: Path, params: dict, *, max_disk_space: Optional[int] = None
) -> None:
    """Persist a converted block's parameters (dense and quantized leaves)."""
    arrays = {}
    manifest = {}
    est_bytes = 0
    for name, leaf in params.items():
        if isinstance(leaf, OutlierQuantLinear):
            data, dtag = _to_numpy(leaf.inner.data)
            scales, stag = _to_numpy(leaf.inner.scales)
            idx, itag = _to_numpy(leaf.idx)
            w_out, wtag = _to_numpy(leaf.w_out)
            arrays[f"q:{name}:data"] = data
            arrays[f"q:{name}:scales"] = scales
            arrays[f"o:{name}:idx"] = idx
            arrays[f"o:{name}:w"] = w_out
            est_bytes += data.nbytes + scales.nbytes + idx.nbytes + w_out.nbytes
            manifest[name] = {
                "quant": leaf.inner.kind,
                "outlier": True,
                "in": leaf.inner.in_features,
                "out": leaf.inner.out_features,
                "dtag": dtag,
                "stag": stag,
                "wtag": wtag,
                "itag": itag,
            }
        elif isinstance(leaf, QuantizedLinear):
            data, dtag = _to_numpy(leaf.data)
            scales, stag = _to_numpy(leaf.scales)
            arrays[f"q:{name}:data"] = data
            arrays[f"q:{name}:scales"] = scales
            est_bytes += data.nbytes + scales.nbytes
            manifest[name] = {
                "quant": leaf.kind,
                "in": leaf.in_features,
                "out": leaf.out_features,
                "dtag": dtag,
                "stag": stag,
            }
        else:
            arr, tag = _to_numpy(leaf)
            arrays[f"d:{name}"] = arr
            est_bytes += arr.nbytes
            manifest[name] = {"tag": tag}
    unit = path.parent
    if max_disk_space is None:
        from petals_tpu_torch.utils.hub import default_max_disk_space

        max_disk_space = default_max_disk_space()
    # eviction first, not holding the cache lock ourselves (free_disk_space_for
    # takes it; flock is per-fd, a nested acquire would self-deadlock), and
    # never evicting the entry we are about to write
    free_disk_space_for(
        est_bytes, cache_dir=unit.parent, max_disk_space=max_disk_space, exclude=unit
    )
    unit.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f,
                __manifest__=np.frombuffer(json.dumps(manifest).encode(), np.uint8),
                **arrays,
            )
        os.replace(tmp, path)
    finally:
        with contextlib.suppress(OSError):
            tmp.unlink(missing_ok=True)
    logger.info(f"Cached quantized block: {unit.name} ({est_bytes / 2**20:.0f} MiB)")


def load_quantized_block(path: Path, device="cpu") -> Optional[dict]:
    """Load a converted block's parameters from the cache onto ``device``;
    None on a miss or a corrupt entry (which is dropped)."""
    if not path.exists():
        return None
    unit = path.parent
    try:
        # shared lock: an eviction sweep (exclusive) cannot rmtree the entry
        # mid-read
        with lock_cache_dir(unit.parent, shared=True):
            with np.load(path) as z:
                manifest = json.loads(bytes(z["__manifest__"]))
                params = {}
                for name, meta in manifest.items():
                    if "quant" in meta:
                        q = QuantizedLinear(
                            meta["quant"],
                            _from_numpy(z[f"q:{name}:data"], meta["dtag"], device),
                            _from_numpy(z[f"q:{name}:scales"], meta["stag"], device),
                            meta["in"],
                            meta["out"],
                        )
                        if meta.get("outlier"):
                            q = OutlierQuantLinear(
                                q,
                                _from_numpy(z[f"o:{name}:idx"], meta["itag"], device),
                                _from_numpy(z[f"o:{name}:w"], meta["wtag"], device),
                            )
                        params[name] = q
                    else:
                        params[name] = _from_numpy(z[f"d:{name}"], meta["tag"], device)
        # touch the eviction unit, not the file: free_disk_space_for ranks
        # top-level entries by their own atime (hub.py pattern)
        with contextlib.suppress(OSError):
            os.utime(unit)
        return params
    except Exception as e:  # corrupt/partial file: drop it, re-quantize
        logger.warning(f"Dropping unreadable quantized-cache entry {unit.name}: {e!r}")
        import shutil

        with contextlib.suppress(OSError):
            shutil.rmtree(unit)
        return None
