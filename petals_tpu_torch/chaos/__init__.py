"""Swarm chaos harness: deterministic fault injection at named sites.

Gated by ``PETALS_TPU_CHAOS`` (or programmatic :func:`configure`); see
:mod:`petals_tpu_torch.chaos.plane` for the spec grammar and site list.
"""

from petals_tpu_torch.chaos import plane as _plane_mod
from petals_tpu_torch.chaos.plane import (
    ACTIONS,
    MAX_LOG,
    SITES,
    SITE_ANNOUNCE,
    SITE_DHT_LOOKUP,
    SITE_HANDLER_STEP,
    SITE_HANDOFF_PUSH,
    SITE_INTEGRITY_CORRUPT,
    SITE_MIGRATE_PUSH,
    SITE_RPC_CALL,
    SITE_RPC_STREAM,
    SITE_RPC_STREAM_RECV,
    SITE_SWAP_RESERVE,
    ChaosInjected,
    ChaosPlane,
    ChaosRule,
    configure,
    corrupt_array,
    disable,
    fire,
    get_plane,
    inject,
    parse_spec,
)

def __getattr__(name):
    # `ENABLED` is mutable state on the plane module (configure()/disable()
    # flip it); a from-import here would freeze the armed/disarmed snapshot
    # taken at package import, so delegate the read instead. Call sites do
    # `chaos.ENABLED` on this package and always see the live value.
    if name == "ENABLED":
        return _plane_mod.ENABLED
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ACTIONS",
    "ENABLED",
    "MAX_LOG",
    "SITES",
    "SITE_ANNOUNCE",
    "SITE_DHT_LOOKUP",
    "SITE_HANDLER_STEP",
    "SITE_HANDOFF_PUSH",
    "SITE_INTEGRITY_CORRUPT",
    "SITE_MIGRATE_PUSH",
    "SITE_RPC_CALL",
    "SITE_RPC_STREAM",
    "SITE_RPC_STREAM_RECV",
    "SITE_SWAP_RESERVE",
    "ChaosInjected",
    "ChaosPlane",
    "ChaosRule",
    "configure",
    "corrupt_array",
    "disable",
    "fire",
    "get_plane",
    "inject",
    "parse_spec",
]
