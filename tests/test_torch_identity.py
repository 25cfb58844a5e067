"""The port's identity plane against petals_tpu's: Ed25519 keys and
signatures (the port's pure-Python RFC 8032 copy, petals_tpu's copy, and
the `cryptography` package), RFC 8032's test vector 1, the canonical
announcement bytes, signed announcements crossing both ways, and tampered
records refused by both packages. All exact: bytes must be identical."""

import hashlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey as CryptoPrivateKey

from petals_tpu.dht import _ed25519_fallback as jax_ed
from petals_tpu.dht import identity as jax_ident
from petals_tpu_torch.dht import _ed25519_fallback as port_ed
from petals_tpu_torch.dht import identity as port_ident

pytestmark = pytest.mark.timeout(120)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# RFC 8032 section 7.1, TEST 1 (an empty message)
RFC_SECRET = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
RFC_PUBLIC = bytes.fromhex("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a")
RFC_SIGNATURE = bytes.fromhex(
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
)


def _messages(seed: int):
    rng = np.random.RandomState(seed)
    return [b"", b"ptu", bytes(rng.randint(0, 256, 1).astype(np.uint8)),
            bytes(rng.randint(0, 256, 1000).astype(np.uint8))]


@pytest.mark.parametrize("seed", range(4))
def test_fallback_keys_and_signatures_are_byte_identical(seed):
    secret = hashlib.sha256(f"seed-{seed}".encode()).digest()
    port_key = port_ed.Ed25519PrivateKey.from_private_bytes(secret)
    jax_key = jax_ed.Ed25519PrivateKey.from_private_bytes(secret)
    crypto_key = CryptoPrivateKey.from_private_bytes(secret)
    public = port_key.public_key().public_bytes_raw()
    assert public == jax_key.public_key().public_bytes_raw() == crypto_key.public_key().public_bytes_raw()
    for message in _messages(seed):
        sig = port_key.sign(message)
        assert sig == jax_key.sign(message) == crypto_key.sign(message)
        port_ed.Ed25519PublicKey.from_public_bytes(public).verify(sig, message)
        crypto_key.public_key().verify(sig, message)
        with pytest.raises(port_ed.InvalidSignature):
            port_ed.Ed25519PublicKey.from_public_bytes(public).verify(sig, message + b"x")
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        with pytest.raises(port_ed.InvalidSignature):
            port_ed.Ed25519PublicKey.from_public_bytes(public).verify(bad, message)


def test_rfc8032_test_vector_1():
    key = port_ed.Ed25519PrivateKey.from_private_bytes(RFC_SECRET)
    assert key.public_key().public_bytes_raw() == RFC_PUBLIC
    assert key.sign(b"") == RFC_SIGNATURE
    port_ed.Ed25519PublicKey.from_public_bytes(RFC_PUBLIC).verify(RFC_SIGNATURE, b"")
    assert port_ident.verify(RFC_PUBLIC, RFC_SIGNATURE, b"")


def test_fallback_alone_signs_and_verifies():
    """Where `cryptography` is missing (the CUDA machine), the port's
    identity module runs on its own RFC 8032 copy."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["cryptography"] = None  # as if it were not installed
        from petals_tpu_torch.dht import identity
        assert identity.Ed25519PrivateKey.__module__ == "petals_tpu_torch.dht._ed25519_fallback"
        me = identity.Identity.from_seed(b"alone")
        rec = identity.sign_announcement(me, "m.0", {"info": [2, 1.5]}, 1000.0)
        assert identity.verify_announcement(rec, me.peer_id.to_string(), 1000.0)
        assert not identity.verify_announcement(rec, me.peer_id.to_string(), 1001.0)
        print(me.public_bytes.hex())
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[-1] == jax_ident.Identity.from_seed(b"alone").public_bytes.hex()


def test_identity_from_seed_matches():
    for seed in (b"a", b"bootstrap", b"\x00" * 40):
        port, jax = port_ident.Identity.from_seed(seed), jax_ident.Identity.from_seed(seed)
        assert port.public_bytes == jax.public_bytes
        assert port.peer_id.to_string() == jax.peer_id.to_string()
        assert port.peer_id.to_string() == port_ident.peer_id_of(port.public_bytes).to_string()
        nonce = os.urandom(16)
        msg = port_ident.hello_challenge_message(port.public_bytes, b"p" * 32, nonce)
        assert msg == jax_ident.hello_challenge_message(jax.public_bytes, b"p" * 32, nonce)
        assert port.sign(msg) == jax.sign(msg)


PAYLOADS = [
    {"info": [2, 1.5, {"version": "0.1.0", "next_pings": {"ab": 0.01}, "adapters": []}], "addr": ["127.0.0.1", 5, "ff"]},
    {"prefix": "tiny-llama-hf", "num_blocks": 4, "public_name": None, "model_type": "llama"},
    [1, 2.25, "x", None, True, {"nested": [{"k": -3}]}],
    "plain",
]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["server_info", "registry", "list", "str"])
def test_announce_message_bytes_identical(payload):
    for exp in (0.0, 1234.5678, 1.7e9 + 0.0004):
        assert port_ident.announce_message("m.3", "ab" * 32, payload, exp) == jax_ident.announce_message(
            "m.3", "ab" * 32, payload, exp
        )


@pytest.mark.parametrize("signer", ["jax", "port"])
def test_signed_announcements_cross_both_ways(signer):
    modules = {"jax": jax_ident, "port": port_ident}
    other = modules["port" if signer == "jax" else "jax"]
    me = modules[signer].Identity.from_seed(b"writer")
    subkey = me.peer_id.to_string()
    exp = 1_800_000_000.123
    record = modules[signer].sign_announcement(me, "m.3", PAYLOADS[0], exp)
    assert record == other.sign_announcement(other.Identity.from_seed(b"writer"), "m.3", PAYLOADS[0], exp)
    for module in (jax_ident, port_ident):
        assert module.verify_announcement(record, subkey, exp)


@pytest.mark.parametrize("signer", ["jax", "port"])
def test_tampered_records_refused_by_both(signer):
    modules = {"jax": jax_ident, "port": port_ident}
    me = modules[signer].Identity.from_seed(b"victim")
    subkey = me.peer_id.to_string()
    exp = 1_800_000_000.0
    record = modules[signer].sign_announcement(me, "m.3", PAYLOADS[0], exp)
    someone = modules[signer].Identity.from_seed(b"someone").peer_id.to_string()
    forged = modules[signer].sign_announcement(modules[signer].Identity.from_seed(b"someone"), "m.3", PAYLOADS[0], exp)
    cases = [
        (dict(record, payload={**PAYLOADS[0], "addr": ["10.0.0.1", 5, "ff"]}), subkey, exp),  # payload
        (record, subkey, exp + 1),  # expiry
        (record, someone, exp),  # subkey of another peer
        (dict(record, uid="m.4"), subkey, exp),  # uid
        (forged, subkey, exp),  # another key's signature under the victim's subkey
        (dict(record, sig="00" * 64), subkey, exp),
        ({"payload": 1}, subkey, exp),
        ("not-a-record", subkey, exp),
    ]
    for module in (jax_ident, port_ident):
        assert module.verify_announcement(record, subkey, exp)
        for value, sk, e in cases:
            assert not module.verify_announcement(value, sk, e)
