"""Cross-process disk-cache management with a size budget
(petals_tpu/utils/disk_cache.py; the Petals disk cache, src/petals/utils/disk_cache.py:18-83).

Used by checkpoint/adapter download paths (when a hub is reachable) and by the
throughput cache: a shared fcntl lock serializes mutations, and an LRU sweep
frees space for new artifacts under ``--max_disk_space``.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import shutil
import time
from pathlib import Path
from typing import Optional

from petals_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_CACHE_DIR = Path(os.environ.get("PETALS_TPU_TORCH_CACHE") or Path.home() / ".cache" / "petals_tpu_torch")
_LOCK_NAME = ".cache.lock"


@contextlib.contextmanager
def lock_cache_dir(cache_dir: Optional[Path] = None, *, shared: bool = False):
    """flock over the cache dir: shared for readers, exclusive for mutation
    (reference disk_cache.py:18-38)."""
    cache_dir = Path(cache_dir or DEFAULT_CACHE_DIR)
    cache_dir.mkdir(parents=True, exist_ok=True)
    lock_path = cache_dir / _LOCK_NAME
    with open(lock_path, "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
        try:
            yield cache_dir
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def cache_size_bytes(cache_dir: Optional[Path] = None) -> int:
    cache_dir = Path(cache_dir or DEFAULT_CACHE_DIR)
    total = 0
    for root, _dirs, files in os.walk(cache_dir):
        for name in files:
            with contextlib.suppress(OSError):
                total += os.path.getsize(os.path.join(root, name))
    return total


def free_disk_space_for(
    needed_bytes: int,
    *,
    cache_dir: Optional[Path] = None,
    max_disk_space: Optional[int] = None,
    exclude: Optional[Path] = None,
) -> None:
    """Evict least-recently-used top-level cache entries until ``needed_bytes``
    fits under ``max_disk_space`` (reference disk_cache.py:41-83). ``exclude``
    protects the entry currently being populated from evicting itself."""
    if max_disk_space is None:
        return
    exclude = Path(exclude).resolve() if exclude is not None else None
    with lock_cache_dir(cache_dir) as cache_dir:
        entries = []
        protected_bytes = 0
        for child in cache_dir.iterdir():
            if child.name == _LOCK_NAME:
                continue
            try:
                stat = child.stat()
                size = (
                    sum(f.stat().st_size for f in child.rglob("*") if f.is_file())
                    if child.is_dir()
                    else stat.st_size
                )
            except OSError:
                continue
            if exclude is not None and child.resolve() == exclude:
                protected_bytes += size  # counts toward the budget, never evicted
                continue
            entries.append((stat.st_atime, size, child))

        current = sum(size for _, size, _ in entries) + protected_bytes
        for atime, size, child in sorted(entries):
            if current + needed_bytes <= max_disk_space:
                break
            logger.info(
                f"Evicting {child.name} ({size / 2**20:.0f} MiB, "
                # swarmlint: disable=no-naive-wallclock-in-span — st_atime is
                # epoch time; only the wall clock is comparable to it, and the
                # age here is a log cosmetic, not a latency span
                f"last used {time.time() - atime:.0f}s ago) to free cache space"
            )
            if child.is_dir():
                shutil.rmtree(child, ignore_errors=True)
            else:
                with contextlib.suppress(OSError):
                    child.unlink()
            current -= size
        if current + needed_bytes > max_disk_space:
            raise OSError(
                f"Insufficient disk space: need {needed_bytes} bytes but only "
                f"{max_disk_space - current} available under the cache budget"
            )
