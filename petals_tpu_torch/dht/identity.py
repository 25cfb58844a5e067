"""Cryptographic peer identities for the swarm plane, the port's copy of
petals_tpu/dht/identity.py (the same keys, messages and signatures):

- a PeerID is the SHA-256 of the node's Ed25519 public key, so nobody can
  claim an id without its private key;
- RPC hellos are challenge and response: each side signs the other's nonce,
  and a connection's remote_peer_id is set only once that is PROVEN;
- a per-peer DHT announcement (a subkey record) is signed over a canonical
  form of (uid, subkey, payload, expiration); storers and readers verify it
  and refuse a record whose signer does not hash to its subkey.

Uses the `cryptography` package where it is installed, else the pure-Python
RFC 8032 copy in dht/_ed25519_fallback.py.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey, Ed25519PublicKey
except ModuleNotFoundError:
    from petals_tpu_torch.dht._ed25519_fallback import Ed25519PrivateKey, Ed25519PublicKey, InvalidSignature

from petals_tpu_torch.data_structures import PeerID

_HELLO_CONTEXT = b"ptu-hello-v1|"
_ANNOUNCE_CONTEXT = b"ptu-announce-v1|"


class Identity:
    """An Ed25519 keypair whose public-key hash IS the peer id."""

    __slots__ = ("_private", "_public_bytes", "_peer_id")

    def __init__(self, private: Ed25519PrivateKey):
        self._private = private
        self._public_bytes = private.public_key().public_bytes_raw()
        self._peer_id = peer_id_of(self._public_bytes)

    @classmethod
    def generate(cls) -> "Identity":
        return cls(Ed25519PrivateKey.generate())

    @classmethod
    def from_seed(cls, seed: bytes) -> "Identity":
        """A deterministic identity (a stable address for a bootstrap node)."""
        return cls(Ed25519PrivateKey.from_private_bytes(hashlib.sha256(seed).digest()))

    @property
    def peer_id(self) -> PeerID:
        return self._peer_id

    @property
    def public_bytes(self) -> bytes:
        return self._public_bytes

    def sign(self, message: bytes) -> bytes:
        return self._private.sign(message)


def peer_id_of(public_bytes: bytes) -> PeerID:
    return PeerID(hashlib.sha256(public_bytes).digest())


def verify(public_bytes: bytes, signature: bytes, message: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(public_bytes).verify(signature, message)
        return True
    except (InvalidSignature, ValueError, TypeError):
        return False


def hello_challenge_message(signer_public: bytes, peer_public: bytes, peer_nonce: bytes) -> bytes:
    """What a node signs to prove its identity to ``peer``: its own public
    key bound to the peer's key and nonce, so a man in the middle cannot
    relay an honest peer's proof as its own."""
    return _HELLO_CONTEXT + signer_public + b"|" + peer_public + peer_nonce


def announce_message(uid: str, subkey: str, payload: Any, expiration: float) -> bytes:
    """The canonical signing form of one DHT announcement: sorted-key JSON of
    plain msgpack types, so writer and verifier serialize it identically."""
    body = json.dumps(
        {"uid": uid, "subkey": subkey, "payload": payload, "exp": round(float(expiration), 3)},
        sort_keys=True,
        separators=(",", ":"),
        ensure_ascii=True,
    )
    return _ANNOUNCE_CONTEXT + body.encode()


def sign_announcement(identity: Identity, uid: str, payload: Any, expiration: float) -> dict:
    """Wrap ``payload`` in a signed record for subkey = our peer id."""
    subkey = identity.peer_id.to_string()
    message = announce_message(uid, subkey, payload, expiration)
    return {
        "uid": uid,
        "payload": payload,
        "pub": identity.public_bytes.hex(),
        "sig": identity.sign(message).hex(),
    }


def verify_announcement(value: Any, subkey: Optional[str], expiration: float) -> bool:
    """True iff ``value`` is a well-formed signed record whose signature is
    valid and whose signer's key hashes to ``subkey``."""
    if not isinstance(value, dict) or subkey is None:
        return False
    try:
        public_bytes = bytes.fromhex(value["pub"])
        signature = bytes.fromhex(value["sig"])
        uid = value["uid"]
        payload = value["payload"]
    except (KeyError, TypeError, ValueError):
        return False
    if peer_id_of(public_bytes).to_string() != subkey:
        return False
    return verify(public_bytes, signature, announce_message(uid, subkey, payload, expiration))
