"""The swarm's shared records, the port's own copy of
petals_tpu/data_structures.py: module UIDs, peer ids, the ServerInfo a
server announces to the DHT directory, and the inference bookkeeping of the
wire protocol. The records travel as the same msgpack tuples, so a port
server and a petals_tpu server read each other's announcements."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import secrets
from enum import IntEnum
from typing import Any, Dict, Optional, Sequence, Tuple

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


def join_uids(uids: Sequence[ModuleUID]) -> str:
    return CHAIN_DELIMITER.join(uids)


def split_chain(chain: str) -> Tuple[ModuleUID, ...]:
    return tuple(chain.split(CHAIN_DELIMITER))


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


class PeerID:
    """A swarm participant's id: 32 raw bytes (the SHA-256 of its Ed25519
    public key, dht/identity.py), written as hex."""

    __slots__ = ("_bytes",)

    def __init__(self, raw: bytes):
        if not isinstance(raw, bytes) or len(raw) != 32:
            raise ValueError("PeerID must wrap exactly 32 bytes")
        self._bytes = raw

    @classmethod
    def generate(cls) -> "PeerID":
        return cls(secrets.token_bytes(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "PeerID":
        return cls(hashlib.sha256(seed).digest())

    @classmethod
    def from_string(cls, s: str) -> "PeerID":
        return cls(bytes.fromhex(s))

    def to_string(self) -> str:
        return self._bytes.hex()

    def to_bytes(self) -> bytes:
        return self._bytes

    def __bytes__(self) -> bytes:
        return self._bytes

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PeerID) and other._bytes == self._bytes

    def __hash__(self) -> int:
        return hash(self._bytes)

    def __lt__(self, other: "PeerID") -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        s = self.to_string()
        return f"PeerID({s[:8]}…{s[-4:]})"


class ServerState(IntEnum):
    OFFLINE = 0
    JOINING = 1
    ONLINE = 2


RPS = float


@dataclasses.dataclass
class ServerInfo:
    """Everything a server publishes about itself to the DHT directory, field
    for field as petals_tpu announces it (its comments say what each field
    drives). A port server announces ``None`` for the features it lacks."""

    state: ServerState
    throughput: RPS

    start_block: Optional[int] = None
    end_block: Optional[int] = None

    public_name: Optional[str] = None
    version: Optional[str] = None

    network_rps: Optional[RPS] = None
    forward_rps: Optional[RPS] = None
    inference_rps: Optional[RPS] = None

    adapters: Sequence[str] = ()
    compute_dtype: Optional[str] = None
    quant_type: Optional[str] = None
    using_relay: Optional[bool] = None
    cache_tokens_left: Optional[int] = None
    next_pings: Optional[Dict[str, float]] = None  # peer id hex -> RTT seconds
    server_gen: Optional[bool] = None  # device-side greedy generation
    server_gen_sampling: Optional[bool] = None  # ...and its sampling variant
    spec_k: Optional[int] = None  # drafts verified per lane per tick
    pool: Optional[Dict[str, Any]] = None  # lane-pool occupancy
    telemetry: Optional[Dict[str, Any]] = None
    compile_stats: Optional[Dict[str, Any]] = None
    integrity: Optional[Dict[str, Any]] = None
    metrics_port: Optional[int] = None
    phase_tier: Optional[str] = None

    def to_tuple(self) -> Tuple[int, float, dict]:
        extra_info = dataclasses.asdict(self)
        del extra_info["state"], extra_info["throughput"]
        extra_info["adapters"] = list(self.adapters)
        return (int(self.state), float(self.throughput), extra_info)

    @classmethod
    def from_tuple(cls, source: tuple) -> "ServerInfo":
        if not isinstance(source, (tuple, list)) or len(source) < 2:
            raise ValueError(f"Expected a tuple of (state, throughput, [extra]), got {source!r}")
        state, throughput = source[:2]
        extra_info = dict(source[2]) if len(source) > 2 and isinstance(source[2], dict) else {}
        # forward compatibility: fields a newer peer announces are dropped
        known = {f.name for f in dataclasses.fields(cls)}
        extra_info = {k: v for k, v in extra_info.items() if k in known}
        extra_info["adapters"] = tuple(extra_info.get("adapters") or ())
        # next_pings is remote-supplied: keep only {str: finite number}, so one
        # malformed announce cannot break every reader's routing
        raw_pings = extra_info.get("next_pings")
        if raw_pings is not None:
            cleaned = {}
            if isinstance(raw_pings, dict):
                for key, value in raw_pings.items():
                    if isinstance(key, str) and isinstance(value, (int, float)) and math.isfinite(value):
                        cleaned[key] = float(value)
            extra_info["next_pings"] = cleaned or None
        return cls(state=ServerState(int(state)), throughput=float(throughput), **extra_info)


@dataclasses.dataclass
class RemoteModuleInfo:
    """A remote module (one block UID) served by one or more peers."""

    uid: ModuleUID
    servers: Dict[PeerID, ServerInfo] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RemoteSpanInfo:
    """A chain of blocks [start, end) served by one peer."""

    peer_id: PeerID
    start: int
    end: int
    server_info: ServerInfo

    @property
    def length(self) -> int:
        return self.end - self.start

    @property
    def state(self) -> ServerState:
        return self.server_info.state

    @property
    def throughput(self) -> float:
        return self.server_info.throughput


def server_info_to_wire(info: ServerInfo) -> Any:
    return list(info.to_tuple())


def server_info_from_wire(obj: Any) -> ServerInfo:
    return ServerInfo.from_tuple(tuple(obj))
