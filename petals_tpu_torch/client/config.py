"""Client configuration, every field of petals_tpu/client/config.py:11-102.

Every field takes petals_tpu's default and works as there.
``active_adapter`` names a LoRA adapter the servers host: routing keeps to
servers that announce it, and every forward, backward and session asks
for it."""

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
    active_adapter: Optional[str] = None  # a LoRA adapter the servers host (by name)

    use_server_to_server: bool = True  # each server pushes its output to the next one

    # scheduling-priority hint ("high" | "normal" | "low") sent in the
    # session-open message; None sends none
    session_priority: Optional[str] = None

    # wire compression of the activations we send and of the replies we ask
    # for ("none" | "float16" | "bfloat16" | "qint8")
    compression: str = "none"

    # live route upgrading: every `route_upgrade_period` seconds a session
    # re-routes and, when the best chain costs at most
    # `route_upgrade_threshold` of the current one's estimated latency,
    # moves its KV there by ptu.session_export; 0 disables
    route_upgrade_period: float = 0.0
    route_upgrade_threshold: float = 0.7

    # deadline of a KV export over the client's link during a repair; on
    # expiry the repair replays the history
    kv_export_timeout: float = 120.0

    # phase tiers: a session whose first step feeds at least
    # `prefill_tier_tokens` tokens routes as "prefill", lighter ones as
    # "decode" (replicas announcing no tier score the same either way). With
    # `disagg_handoff`, a session that prefilled on a prefill-tier replica
    # has its KV pushed to a decode-tier one after the first step, within
    # `handoff_timeout` seconds; a failed handoff decodes where it prefilled
    prefill_tier_tokens: int = 256
    disagg_handoff: bool = True
    handoff_timeout: float = 30.0

    def __post_init__(self):
        if self.prefill_tier_tokens <= 0:
            raise ValueError(f"prefill_tier_tokens must be positive, got {self.prefill_tier_tokens}")
        if self.handoff_timeout <= 0:
            raise ValueError(f"handoff_timeout must be positive, got {self.handoff_timeout}")
        if self.kv_export_timeout <= 0:
            raise ValueError(f"kv_export_timeout must be positive, got {self.kv_export_timeout}")
        if self.max_retries is None:
            env = os.environ.get("PETALS_TPU_MAX_RETRIES")
            self.max_retries = int(env) if env else None
        CompressionType(self.compression)  # fail at construction, not mid-session
        if self.session_priority is not None:
            parse_session_priority(self.session_priority)  # same: fail early
