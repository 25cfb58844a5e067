"""The DHT directory: which peer serves which blocks (the port's copy of
petals_tpu/utils/dht_utils.py, the same records). Key = module UID (e.g.
"llama-hf.3"), subkey = the announcing peer's id, value = a signed record of
its ServerInfo tuple and contact address, each with its own expiration.
Readers verify every record and merge the live announcements of a block.
petals_tpu's fault-injection hook on the lookup is not ported."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Sequence

from petals_tpu_torch import chaos
from petals_tpu_torch.data_structures import (
    ModuleUID,
    PeerID,
    RemoteModuleInfo,
    RemoteSpanInfo,
    ServerInfo,
    ServerState,
    make_uid,
)
from petals_tpu_torch.dht.identity import sign_announcement, verify_announcement
from petals_tpu_torch.dht.node import DHTNode, dht_time
from petals_tpu_torch.dht.routing import PeerAddr

logger = logging.getLogger(__name__)

MODELS_REGISTRY_KEY = "ptu.models"
# registry entries are self-signed, not attested: a bound on num_blocks keeps
# a hostile announcement from making readers enumerate absurd uid ranges
MAX_REGISTRY_BLOCKS = 4096


async def declare_active_modules(
    dht: DHTNode,
    uids: Sequence[ModuleUID],
    server_info: ServerInfo,
    expiration_time: float,
    contact_addr: Optional[PeerAddr] = None,
) -> int:
    """Announce that this peer serves ``uids``, each record signed by the
    node's identity; returns how many records were stored."""
    contact = contact_addr or dht.own_addr
    payload = {"info": list(server_info.to_tuple()), "addr": contact.to_wire() if contact else None}
    subkey = dht.peer_id.to_string()
    results = await asyncio.gather(*(
        dht.store(uid, sign_announcement(dht.identity, uid, payload, expiration_time), expiration_time, subkey=subkey)
        for uid in uids
    ))
    return sum(bool(r) for r in results)


async def get_remote_module_infos(dht: DHTNode, uids: Sequence[ModuleUID], *, active_adapter: Optional[str] = None):
    """The servers of each UID (None where nobody serves the block).

    Returns (infos, addr_book): infos[i] is a RemoteModuleInfo or None, and
    addr_book maps peer ids to their announced contact addresses."""
    if chaos.ENABLED:
        await chaos.inject(chaos.SITE_DHT_LOOKUP, detail=str(uids[0]) if uids else None)
    records = await asyncio.gather(*(dht.get(uid) for uid in uids))
    out: List[Optional[RemoteModuleInfo]] = []
    addr_book: Dict[PeerID, PeerAddr] = {}
    for uid, record in zip(uids, records):
        if record is None or not isinstance(record[0], dict):
            out.append(None)
            continue
        servers: Dict[PeerID, ServerInfo] = {}
        for subkey, (value, expiration) in record[0].items():
            try:
                # readers verify too: a malicious DHT node could serve
                # records that honest storers refused
                if not verify_announcement(value, subkey, expiration) or value["uid"] != uid:
                    logger.debug(f"Dropping an unverified DHT entry for {uid} subkey {subkey!r}")
                    continue
                payload = value["payload"]
                peer_id = PeerID.from_string(subkey)
                info = ServerInfo.from_tuple(tuple(payload["info"]))
                if active_adapter and active_adapter not in (info.adapters or ()):
                    continue
                servers[peer_id] = info
                if payload.get("addr"):
                    addr_book[peer_id] = PeerAddr.from_wire(payload["addr"])
            except (ValueError, KeyError, TypeError) as e:
                logger.debug(f"Incorrect DHT entry for {uid} subkey {subkey!r}: {e}")
        out.append(RemoteModuleInfo(uid=uid, servers=servers) if servers else None)
    return out, addr_book


class ModuleDirectory:
    """A fetch helper that keeps the peer-id -> contact-address book."""

    def __init__(self, dht: DHTNode):
        self.dht = dht
        self.addr_book: Dict[PeerID, PeerAddr] = {}

    async def declare(self, uids, server_info, expiration_time, contact_addr=None) -> int:
        return await declare_active_modules(self.dht, uids, server_info, expiration_time, contact_addr)

    async def fetch(self, uids, active_adapter=None) -> List[Optional[RemoteModuleInfo]]:
        infos, addr_book = await get_remote_module_infos(self.dht, uids, active_adapter=active_adapter)
        self.addr_book.update(addr_book)
        return infos

    def addr_of(self, peer_id: PeerID) -> Optional[PeerAddr]:
        return self.addr_book.get(peer_id)


async def declare_model(
    dht: DHTNode,
    dht_prefix: str,
    *,
    num_blocks: int,
    expiration_time: float,
    public_name: Optional[str] = None,
    model_type: Optional[str] = None,
) -> bool:
    """Register the hosted model in the swarm-wide registry, so monitors and
    clients find what the swarm serves without knowing its prefixes."""
    payload = {
        "prefix": dht_prefix,
        "num_blocks": int(num_blocks),
        "public_name": public_name,
        "model_type": model_type,
    }
    return await dht.store(
        MODELS_REGISTRY_KEY,
        sign_announcement(dht.identity, MODELS_REGISTRY_KEY, payload, expiration_time),
        expiration_time,
        subkey=dht.peer_id.to_string(),
    )


async def list_models(dht: DHTNode) -> Dict[str, dict]:
    """{dht_prefix: {"num_blocks", "public_name", "model_type", "peers"}}
    over the live, verified registry announcements."""
    record = await dht.get(MODELS_REGISTRY_KEY)
    models: Dict[str, dict] = {}
    if record is None or not isinstance(record[0], dict):
        return models
    for subkey, (value, expiration) in record[0].items():
        try:
            # the uid check keeps a module record from being replayed here
            if not verify_announcement(value, subkey, expiration) or value["uid"] != MODELS_REGISTRY_KEY:
                continue
            payload = value["payload"]
            num_blocks = int(payload["num_blocks"])
            if not 1 <= num_blocks <= MAX_REGISTRY_BLOCKS:
                continue
            entry = models.setdefault(payload["prefix"], {
                "num_blocks": num_blocks,
                "public_name": payload.get("public_name"),
                "model_type": payload.get("model_type"),
                "peers": [],
            })
            entry["peers"].append(subkey)
            entry["num_blocks"] = max(entry["num_blocks"], num_blocks)
        except (ValueError, KeyError, TypeError) as e:
            logger.debug(f"Incorrect models-registry entry {subkey!r}: {e}")
    return models


def compute_spans(
    module_infos: Sequence[Optional[RemoteModuleInfo]], *, min_state: ServerState = ServerState.ONLINE
) -> Dict[PeerID, RemoteSpanInfo]:
    """Per-block announcements joined into contiguous per-peer spans."""
    spans: Dict[PeerID, RemoteSpanInfo] = {}
    for block_idx, info in enumerate(module_infos):
        if info is None:
            continue
        for peer_id, server_info in info.servers.items():
            if server_info.state.value < min_state.value:
                continue
            if peer_id in spans and spans[peer_id].end == block_idx:
                spans[peer_id].end = block_idx + 1
                spans[peer_id].server_info = server_info
            else:
                # a peer restarted on a new range keeps only its newest span
                spans[peer_id] = RemoteSpanInfo(
                    peer_id=peer_id, start=block_idx, end=block_idx + 1, server_info=server_info
                )
    return spans


def module_uids(dht_prefix: str, block_indices: range) -> List[ModuleUID]:
    return [make_uid(dht_prefix, i) for i in block_indices]


def default_expiration(update_period: float) -> float:
    return dht_time() + max(2 * update_period, 60.0)
