"""Streaming HF-Hub checkpoint fetcher: exactly the shards one block span
needs, never the whole model (counterpart of reference
src/petals/server/from_pretrained.py:35-75 resolution, :81-128 shard
filtering, :162-213 retry-forever download loop — rebuilt on urllib against
the Hub's plain-HTTP ``resolve`` endpoint so a private mirror / local fixture
works in zero-egress environments).

Layout mirrors the semantics, not the implementation: files land under
``<cache>/models--{org}--{name}/<filename>`` with atomic renames, a shared
flock serializing mutations (utils/disk_cache.py) and LRU eviction under
``max_disk_space``.

Endpoint: ``PETALS_TPU_HUB_ENDPOINT`` or ``HF_ENDPOINT`` (default
``https://huggingface.co``). URL shape: ``{endpoint}/{repo}/resolve/{rev}/{file}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, Iterable, Optional

from petals_tpu_torch.constants import BIN_INDEX, BIN_SINGLE, SAFE_INDEX, SAFE_SINGLE
from petals_tpu_torch.utils.disk_cache import (
    DEFAULT_CACHE_DIR,
    free_disk_space_for,
    lock_cache_dir,
)
from petals_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

DEFAULT_ENDPOINT = "https://huggingface.co"
_CHUNK = 1 << 20
_MAX_BACKOFF_S = 60.0
_REPO_ID_RE = re.compile(r"^[\w][\w.-]*(/[\w][\w.-]*)?$")
# HTTP statuses that are facts about the repo/credentials, not the link —
# retrying cannot help (gated repos return 401/403 when HF_TOKEN is absent
# or lacks access)
_PERMANENT_HTTP = {401, 403, 404}


class _AuthStrippingRedirectHandler(urllib.request.HTTPRedirectHandler):
    """Drop the Authorization header when a redirect leaves the original host:
    the Hub 302s large files to presigned CDN URLs, where a forwarded Bearer
    token both breaks the request (two auth mechanisms) and leaks the token
    to a third party (huggingface_hub strips it for the same reason)."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        import urllib.parse

        new_req = super().redirect_request(req, fp, code, msg, headers, newurl)
        if new_req is not None:
            old_host = urllib.parse.urlsplit(req.full_url).netloc
            new_host = urllib.parse.urlsplit(newurl).netloc
            if old_host != new_host:
                new_req.remove_header("Authorization")
        return new_req


_opener = urllib.request.build_opener(_AuthStrippingRedirectHandler)


def validate_repo_id(repo_id: str) -> None:
    """Reject strings that are neither a local dir nor a plausible repo id, so
    a typo'd checkpoint path fails fast instead of retrying downloads forever."""
    if not _REPO_ID_RE.match(repo_id):
        raise FileNotFoundError(
            f"{repo_id!r} is not a local directory and does not look like a "
            f"Hub repo id (expected 'org/name')"
        )


def hub_endpoint() -> str:
    return (
        os.environ.get("PETALS_TPU_HUB_ENDPOINT")
        or os.environ.get("HF_ENDPOINT")
        or DEFAULT_ENDPOINT
    ).rstrip("/")


def default_max_retries() -> Optional[int]:
    """None = retry forever (the reference's behavior for swarm servers)."""
    value = os.environ.get("PETALS_TPU_HUB_RETRIES", "").strip()
    if not value:
        return None
    return int(value)


def default_max_disk_space() -> Optional[int]:
    """Cache budget in bytes from PETALS_TPU_MAX_DISK_SPACE (suffixes
    KB/MB/GB/TB accepted, e.g. "300GB" — the reference's --max_disk_space)."""
    value = os.environ.get("PETALS_TPU_MAX_DISK_SPACE", "").strip()
    return parse_size(value) if value else None


def parse_size(value: str) -> int:
    value = value.strip().upper()
    for suffix, mult in (("TB", 1 << 40), ("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10), ("B", 1)):
        if value.endswith(suffix):
            return int(float(value[: -len(suffix)]) * mult)
    return int(value)


def repo_cache_dir(
    repo_id: str, cache_dir: Optional[Path] = None, revision: str = "main"
) -> Path:
    """Cache keyed on (repo, revision) so files from different revisions can
    never be silently mixed."""
    base = Path(cache_dir or DEFAULT_CACHE_DIR)
    return base / ("models--" + repo_id.replace("/", "--")) / revision


def _resolve_url(repo_id: str, filename: str, revision: str) -> str:
    return f"{hub_endpoint()}/{repo_id}/resolve/{revision}/{filename}"


def fetch_file(
    repo_id: str,
    filename: str,
    *,
    revision: str = "main",
    cache_dir: Optional[Path] = None,
    max_disk_space: Optional[int] = None,
    max_retries: Optional[int] = None,
    timeout: float = 30.0,
) -> Path:
    """Download one repo file into the cache (no-op when already present).

    Retries with capped exponential backoff; ``max_retries=None`` retries
    forever like the reference's server loop (from_pretrained.py:162-213) so a
    flaky link cannot kill a joining server. 401/403/404 are never retried —
    they're facts about the repo/credentials, not the link.
    """
    validate_repo_id(repo_id)
    repo_dir = repo_cache_dir(repo_id, cache_dir, revision)
    target = _safe_target(repo_dir, filename)
    top_dir = repo_dir.parent  # models--org--name: the LRU eviction unit
    if target.exists():
        # touch the eviction unit, not the file: free_disk_space_for ranks
        # top-level entries by their own atime
        with contextlib.suppress(OSError):
            os.utime(top_dir)
        return target
    if max_retries is None:
        max_retries = default_max_retries()
    if max_disk_space is None:
        max_disk_space = default_max_disk_space()

    url = _resolve_url(repo_id, filename, revision)
    attempt = 0
    delay = 1.0
    while True:
        try:
            return _fetch_once(
                url, target, exclude=top_dir,
                cache_dir=cache_dir, max_disk_space=max_disk_space, timeout=timeout,
            )
        except FileNotFoundError:
            raise
        except PermissionError:
            raise
        except Exception as e:
            attempt += 1
            if max_retries is not None and attempt > max_retries:
                raise OSError(
                    f"Failed to download {url} after {attempt} attempts: {e}"
                ) from e
            logger.warning(
                f"Download of {url} failed ({e}); retry {attempt} in {delay:.0f}s"
            )
            time.sleep(delay)
            delay = min(delay * 1.5, _MAX_BACKOFF_S)


def _safe_target(repo_dir: Path, filename: str) -> Path:
    """Join an index-supplied (untrusted) filename, refusing anything that
    escapes the repo's cache directory."""
    if os.path.isabs(filename):
        raise ValueError(f"Absolute shard path {filename!r} in checkpoint index")
    target = (repo_dir / filename).resolve()
    if not target.is_relative_to(repo_dir.resolve()):
        raise ValueError(
            f"Shard path {filename!r} escapes the repo cache directory"
        )
    return target


def _fetch_once(
    url: str,
    target: Path,
    *,
    exclude: Path,
    cache_dir: Optional[Path],
    max_disk_space: Optional[int],
    timeout: float,
) -> Path:
    request = urllib.request.Request(url)
    token = os.environ.get("PETALS_TPU_HUB_TOKEN") or os.environ.get("HF_TOKEN")
    if token:
        request.add_header("Authorization", f"Bearer {token}")
    try:
        response = _opener.open(request, timeout=timeout)
    except urllib.error.HTTPError as e:
        if e.code == 404:
            raise FileNotFoundError(f"{url} -> HTTP 404") from e
        if e.code in _PERMANENT_HTTP:
            hint = "is HF_TOKEN valid?" if token else "gated/private repo? set HF_TOKEN"
            raise PermissionError(f"{url} -> HTTP {e.code} ({hint})") from e
        raise
    with response:
        size = int(response.headers.get("Content-Length") or 0)
        if size and max_disk_space:
            # never evict the repo we're in the middle of populating
            free_disk_space_for(
                size, cache_dir=cache_dir, max_disk_space=max_disk_space,
                exclude=exclude,
            )
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.tmp.{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                while True:
                    chunk = response.read(_CHUNK)
                    if not chunk:
                        break
                    f.write(chunk)
            with lock_cache_dir(cache_dir):
                os.replace(tmp, target)
        finally:
            with contextlib.suppress(OSError):
                tmp.unlink()
    with contextlib.suppress(OSError):
        os.utime(exclude)
    logger.info(f"Fetched {target.name} ({target.stat().st_size / 2**20:.1f} MiB)")
    return target


def ensure_config(
    repo_id: str,
    *,
    revision: str = "main",
    cache_dir: Optional[Path] = None,
    max_disk_space: Optional[int] = None,
    max_retries: Optional[int] = None,
) -> Path:
    """Fetch config.json; returns the repo's cache directory (usable as a
    local checkpoint dir for AutoConfig)."""
    fetch_file(
        repo_id, "config.json", revision=revision, cache_dir=cache_dir,
        max_disk_space=max_disk_space, max_retries=max_retries,
    )
    return repo_cache_dir(repo_id, cache_dir, revision)


def _fetch_index(
    repo_id: str, *, revision: str, cache_dir: Optional[Path],
    max_disk_space: Optional[int], max_retries: Optional[int],
) -> Optional[Dict[str, str]]:
    """weight_map from whichever index exists; None -> single-file checkpoint."""
    for index_name in (SAFE_INDEX, BIN_INDEX):
        try:
            path = fetch_file(
                repo_id, index_name, revision=revision, cache_dir=cache_dir,
                max_disk_space=max_disk_space, max_retries=max_retries,
            )
        except FileNotFoundError:
            continue
        with open(path) as f:
            return json.load(f)["weight_map"]
    return None


def ensure_weight_files(
    repo_id: str,
    prefixes: Iterable[str],
    *,
    revision: str = "main",
    cache_dir: Optional[Path] = None,
    max_disk_space: Optional[int] = None,
    max_retries: Optional[int] = None,
) -> Path:
    """Fetch ONLY the weight shards containing tensors under ``prefixes``
    (reference from_pretrained.py:81-128: one block's files, not the model).
    Returns the repo cache dir, which then reads like a (partial) local
    checkpoint directory."""
    prefixes = tuple(prefixes)
    ensure_config(
        repo_id, revision=revision, cache_dir=cache_dir,
        max_disk_space=max_disk_space, max_retries=max_retries,
    )
    weight_map = _fetch_index(
        repo_id, revision=revision, cache_dir=cache_dir,
        max_disk_space=max_disk_space, max_retries=max_retries,
    )
    if weight_map is None:
        # unsharded checkpoint: the single file is the smallest fetchable unit
        for single in (SAFE_SINGLE, BIN_SINGLE):
            try:
                fetch_file(
                    repo_id, single, revision=revision, cache_dir=cache_dir,
                    max_disk_space=max_disk_space, max_retries=max_retries,
                )
                return repo_cache_dir(repo_id, cache_dir, revision)
            except FileNotFoundError:
                continue
        raise FileNotFoundError(f"No weight files found for {repo_id!r}")

    needed = sorted(
        {
            fname
            for name, fname in weight_map.items()
            if any(name.startswith(p) for p in prefixes)
        }
    )
    if not needed:
        raise KeyError(
            f"No tensors under prefixes {list(prefixes)} in {repo_id!r}'s index"
        )
    for fname in needed:
        fetch_file(
            repo_id, fname, revision=revision, cache_dir=cache_dir,
            max_disk_space=max_disk_space, max_retries=max_retries,
        )
    return repo_cache_dir(repo_id, cache_dir, revision)
