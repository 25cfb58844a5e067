"""Client configuration, every field of petals_tpu/client/config.py:11-102.

Fields whose machinery waits for a later slice are refused at construction
when set away from their defaults: ``route_upgrade_period`` and
``route_upgrade_threshold`` (live route upgrades, A9), ``kv_export_timeout``
and ``handoff_timeout`` (KV export and the prefill-to-decode handoff, A9),
``compression="qint8"`` (the qint8 codec, A3) and ``active_adapter``
(adapters, A13). ``use_server_to_server`` and ``disagg_handoff`` keep
petals_tpu's defaults (True), which do nothing until A9; False, what the
port does anyway (the client relays every hop and never hands a session's
KV over), is accepted."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

from petals_tpu_torch.data_structures import parse_session_priority
from petals_tpu_torch.rpc.serialization import CompressionType


@dataclasses.dataclass
class ClientConfig:
    initial_peers: Sequence[str] = ()  # PeerAddr strings "host:port/peer_id"
    dht_prefix: Optional[str] = None

    show_route: bool = False  # log the chosen chain on (re)builds
    allowed_servers: Optional[Sequence[str]] = None  # peer id hex allowlist
    blocked_servers: Optional[Sequence[str]] = None  # peer id hex blocklist

    request_timeout: float = 3 * 60.0
    session_timeout: float = 30 * 60.0
    connect_timeout: float = 5.0
    update_period: float = 60.0

    max_retries: Optional[int] = None  # None = retry forever (PETALS_TPU_MAX_RETRIES overrides)
    min_backoff: float = 1.0
    max_backoff: float = 60.0
    ban_timeout: float = 15.0

    max_pinged: int = 3  # servers pinged per routing update

    # the client's budget (seconds) for the server's lane-admission wait at
    # session open; None = the server's default (30 s)
    alloc_timeout: Optional[float] = None
    active_adapter: Optional[str] = None  # A13

    use_server_to_server: bool = True  # inert until A9: the client relays every hop

    # scheduling-priority hint ("high" | "normal" | "low") sent in the
    # session-open message; None sends none
    session_priority: Optional[str] = None

    # wire compression of the activations we send and of the replies we ask
    # for ("none" | "float16" | "bfloat16"; "qint8" waits for A3)
    compression: str = "none"

    # live route upgrading (A9); 0 disables
    route_upgrade_period: float = 0.0
    route_upgrade_threshold: float = 0.7

    # deadline of a KV export during repair (A9; repairs replay history)
    kv_export_timeout: float = 120.0

    # phase tiers: a session whose first step feeds at least
    # `prefill_tier_tokens` tokens routes as "prefill", lighter ones as
    # "decode" (replicas announcing no tier score the same either way); the
    # prefill-to-decode KV handoff (`disagg_handoff`) waits for A9
    prefill_tier_tokens: int = 256
    disagg_handoff: bool = True
    handoff_timeout: float = 30.0

    def __post_init__(self):
        if self.prefill_tier_tokens <= 0:
            raise ValueError(f"prefill_tier_tokens must be positive, got {self.prefill_tier_tokens}")
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for name, what in (("route_upgrade_period", "live route upgrades over KV export"),
                           ("route_upgrade_threshold", "live route upgrades over KV export"),
                           ("kv_export_timeout", "KV export during repair"),
                           ("handoff_timeout", "the prefill-to-decode KV handoff")):
            if getattr(self, name) != defaults[name]:
                raise NotImplementedError(f"{name}={getattr(self, name)!r} ({what}) waits for A9 in this port")
        if self.compression == "qint8":
            raise NotImplementedError("compression='qint8' waits for the qint8 codec (A3) in this port")
        if self.active_adapter is not None:
            raise NotImplementedError("active_adapter (adapters) waits for A13 in this port")
        if self.max_retries is None:
            env = os.environ.get("PETALS_TPU_MAX_RETRIES")
            self.max_retries = int(env) if env else None
        CompressionType(self.compression)  # fail at construction, not mid-session
        if self.session_priority is not None:
            parse_session_priority(self.session_priority)  # same: fail early
