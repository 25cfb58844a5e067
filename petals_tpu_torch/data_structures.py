"""Module UIDs and inference bookkeeping shared with the swarm's wire
protocol (the subset of petals_tpu/data_structures.py this server uses)."""

from __future__ import annotations

from typing import Tuple

ModuleUID = str
UID_DELIMITER = "."  # e.g. "llama-hf.3" is the 4th block of model prefix "llama-hf"
CHAIN_DELIMITER = " "  # e.g. "llama-hf.3 llama-hf.4" addresses a chain of blocks

Handle = int  # KV-cache handle issued by the server's MemoryCache

# Session priority classes (lower = more important); an inference session's
# open message may carry one as "priority".
SESSION_PRIORITY_HIGH = 0
SESSION_PRIORITY_NORMAL = 1
SESSION_PRIORITY_LOW = 2
_PRIORITY_NAMES = {
    "high": SESSION_PRIORITY_HIGH,
    "normal": SESSION_PRIORITY_NORMAL,
    "low": SESSION_PRIORITY_LOW,
}


def parse_uid(uid: ModuleUID) -> Tuple[str, int]:
    if CHAIN_DELIMITER in uid:
        raise ValueError("parse_uid() does not support chained UIDs")
    dht_prefix, index = uid.rsplit(UID_DELIMITER, 1)
    return dht_prefix, int(index)


def make_uid(dht_prefix: str, block_index: int) -> ModuleUID:
    return f"{dht_prefix}{UID_DELIMITER}{block_index}"


def parse_session_priority(value, default: int = SESSION_PRIORITY_NORMAL) -> int:
    """Normalise a client's priority hint ("high"/"normal"/"low" or an int)."""
    if value is None:
        return default
    if isinstance(value, bool):
        raise ValueError(f"Invalid session priority {value!r}")
    if isinstance(value, int):
        return min(max(value, SESSION_PRIORITY_HIGH), SESSION_PRIORITY_LOW)
    if isinstance(value, str) and value.lower() in _PRIORITY_NAMES:
        return _PRIORITY_NAMES[value.lower()]
    raise ValueError(f"Invalid session priority {value!r}")
