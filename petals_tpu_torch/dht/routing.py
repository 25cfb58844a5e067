"""Kademlia routing table: the XOR metric over 256-bit peer ids and
k-buckets (the port's copy of petals_tpu/dht/routing.py; the relay circuit
addresses it also parses wait for the relay)."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from petals_tpu_torch.data_structures import PeerID

KEY_BITS = 256
DEFAULT_BUCKET_SIZE = 20


@dataclasses.dataclass(frozen=True)
class PeerAddr:
    """Contact info of a DHT peer; textual form ``host:port/peer_id_hex``.
    ``relayed=True`` (textual ``relay+host:port/peer_id_hex``, a fourth wire
    element) names a relay through which a petals_tpu peer must be dialed:
    it is parsed and passed on, and the port's ConnectionPool refuses to
    dial it."""

    host: str
    port: int
    peer_id: PeerID
    relayed: bool = False

    def to_string(self) -> str:
        prefix = "relay+" if self.relayed else ""
        return f"{prefix}{self.host}:{self.port}/{self.peer_id.to_string()}"

    @classmethod
    def from_string(cls, s: str) -> "PeerAddr":
        relayed = s.startswith("relay+")
        if relayed:
            s = s[len("relay+"):]
        hostport, peer_hex = s.rsplit("/", 1)
        host, port = hostport.rsplit(":", 1)
        return cls(host=host, port=int(port), peer_id=PeerID.from_string(peer_hex), relayed=relayed)

    def to_wire(self) -> list:
        wire = [self.host, self.port, self.peer_id.to_string()]
        if self.relayed:
            wire.append(True)  # omitted when direct
        return wire

    @classmethod
    def from_wire(cls, obj) -> "PeerAddr":
        return cls(
            host=obj[0], port=int(obj[1]), peer_id=PeerID.from_string(obj[2]),
            relayed=bool(obj[3]) if len(obj) > 3 else False,
        )


def xor_distance(a: PeerID, b: PeerID) -> int:
    return int.from_bytes(a.to_bytes(), "big") ^ int.from_bytes(b.to_bytes(), "big")


def bucket_index(own: PeerID, other: PeerID) -> int:
    """The position of the highest differing bit (0 if the ids are equal)."""
    dist = xor_distance(own, other)
    return dist.bit_length() - 1 if dist > 0 else 0


@dataclasses.dataclass
class _Contact:
    addr: PeerAddr
    last_seen: float


class RoutingTable:
    def __init__(self, own_id: PeerID, bucket_size: int = DEFAULT_BUCKET_SIZE):
        self.own_id = own_id
        self.bucket_size = bucket_size
        self._buckets: Dict[int, Dict[PeerID, _Contact]] = {}

    def add(self, addr: PeerAddr) -> None:
        if addr.peer_id == self.own_id:
            return
        bucket = self._buckets.setdefault(bucket_index(self.own_id, addr.peer_id), {})
        if addr.peer_id not in bucket and len(bucket) >= self.bucket_size:
            # a full bucket drops its stalest contact (failed calls also
            # evict, through remove())
            del bucket[min(bucket, key=lambda pid: bucket[pid].last_seen)]
        bucket[addr.peer_id] = _Contact(addr, time.monotonic())

    def remove(self, peer_id: PeerID) -> None:
        self._buckets.get(bucket_index(self.own_id, peer_id), {}).pop(peer_id, None)

    def get(self, peer_id: PeerID) -> Optional[PeerAddr]:
        contact = self._buckets.get(bucket_index(self.own_id, peer_id), {}).get(peer_id)
        return contact.addr if contact else None

    def nearest(self, target: PeerID, k: int) -> List[PeerAddr]:
        contacts = self.all_peers()
        contacts.sort(key=lambda a: xor_distance(a.peer_id, target))
        return contacts[:k]

    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def all_peers(self) -> List[PeerAddr]:
        return [c.addr for bucket in self._buckets.values() for c in bucket.values()]
