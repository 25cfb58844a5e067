"""Local DHT record storage with expirations and subkeys (the port's copy of
petals_tpu/dht/storage.py). A key maps either to a plain value or to a
dictionary of subkeys (one per announcing peer), each with its own
expiration in unix seconds; on a conflict the later expiration wins."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

ValueWithExpiration = Tuple[Any, float]


class SubkeyDict(dict):
    """Marks a per-subkey record ({subkey: (value, expiration)}) apart from
    a plain value that happens to be a dict."""


def _live(subdict: SubkeyDict, now: float) -> SubkeyDict:
    return SubkeyDict({sk: (v, e) for sk, (v, e) in subdict.items() if e > now})


class DHTStorage:
    def __init__(self, maxsize: int = 100_000):
        self.maxsize = maxsize
        # key -> (value | {subkey: (value, expiration)}, expiration)
        self._records: Dict[bytes, Tuple[Any, float]] = {}

    def store(self, key: bytes, value: Any, expiration: float, subkey: Optional[str] = None) -> bool:
        if expiration <= time.time():
            return False
        self._evict_expired_if_full()
        existing = self._records.get(key)
        if subkey is None:
            # a plain write replaces a record of either kind only if it is
            # fresher: it never wipes live announcements
            if existing is not None and existing[1] > expiration:
                return False
            self._records[key] = (value, expiration)
            return True
        if existing is not None and isinstance(existing[0], SubkeyDict):
            subdict, top_exp = existing
        elif existing is not None and existing[1] > expiration:
            return False  # a fresher plain record wins over this subkey write
        else:
            subdict, top_exp = SubkeyDict(), 0.0
        prev = subdict.get(subkey)
        if prev is not None and prev[1] > expiration:
            return False
        subdict[subkey] = (value, expiration)
        self._records[key] = (subdict, max(top_exp, expiration))
        return True

    def get(self, key: bytes) -> Optional[ValueWithExpiration]:
        record = self._records.get(key)
        if record is None:
            return None
        value, expiration = record
        now = time.time()
        if isinstance(value, SubkeyDict):
            live = _live(value, now)
            if not live:
                del self._records[key]
                return None
            return live, max(e for _, e in live.values())
        if expiration <= now:
            del self._records[key]
            return None
        return value, expiration

    def remove_expired(self) -> None:
        now = time.time()
        for key in list(self._records):
            value, expiration = self._records[key]
            if isinstance(value, SubkeyDict):
                live = _live(value, now)
                if live:
                    self._records[key] = (live, max(e for _, e in live.values()))
                else:
                    del self._records[key]
            elif expiration <= now:
                del self._records[key]

    def _evict_expired_if_full(self) -> None:
        if len(self._records) >= self.maxsize:
            self.remove_expired()
        if len(self._records) >= self.maxsize:
            # still full: drop the record that expires soonest
            del self._records[min(self._records, key=lambda k: self._records[k][1])]

    def __len__(self) -> int:
        return len(self._records)
