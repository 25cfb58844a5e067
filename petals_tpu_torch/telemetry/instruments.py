"""The swarm's shared named instruments, pre-registered on the global
registry (the port's copy of petals_tpu/telemetry/instruments.py). Hot
paths import these module-level singletons (or pre-resolve a labeled child
once) so recording is a direct method call — no registry lookup per tick.

Every name, help text, label set and bucket edge is petals_tpu's, verbatim,
so a Prometheus scrape reads the same series from either server. Where a
help text speaks of XLA compilations, the port counts the captures of its
step programs (telemetry/observatory.py: a capture stands for a compile).

Label sets here are STATIC (variant/direction enums) — never session ids,
peer ids, or anything else a client controls.
"""

from __future__ import annotations

from petals_tpu_torch.telemetry.registry import get_registry

REGISTRY = get_registry()

# --- request latency -------------------------------------------------------
TTFT = REGISTRY.histogram(
    "petals_ttft_seconds",
    "Time from session open to the first reply token leaving the handler",
)
TOKEN_LATENCY = REGISTRY.histogram(
    "petals_token_latency_seconds",
    "Per-token server-side decode latency (single-token batched step)",
)
PREFILL_QUEUE_WAIT = REGISTRY.histogram(
    "petals_prefill_queue_wait_seconds",
    "Time a prefill spent queued before its first chunk entered a mixed step",
)
REPLY_SERIALIZE = REGISTRY.histogram(
    "petals_reply_serialize_seconds",
    "Server-side serialization time of one inference reply's tensors",
)
SLO_BREACHES = REGISTRY.counter(
    "petals_slo_breaches_total",
    "Latency SLO breaches captured by the flight recorder, by kind",
    labels=("kind",),  # ttft | token
)

# --- compiled step ---------------------------------------------------------
STEP_DURATION = REGISTRY.histogram(
    "petals_step_duration_seconds",
    "Compiled batched-step wall time by variant",
    labels=("variant",),  # dense | paged | mixed | gen
)
BATCHED_STEPS = REGISTRY.counter(
    "petals_batched_steps_total",
    "Compiled batched steps executed, by variant",
    labels=("variant",),
)
DECODE_TOKENS = REGISTRY.counter(
    "petals_decode_tokens_total",
    "Decode tokens produced across all lanes",
)

# --- speculative decoding ---------------------------------------------------
SPEC_PROPOSED = REGISTRY.counter(
    "petals_spec_proposed_tokens_total",
    "Draft tokens proposed to the verify step across all speculating lanes",
)
SPEC_ACCEPTED = REGISTRY.counter(
    "petals_spec_accepted_tokens_total",
    "Draft tokens accepted by the verify step (emitted minus the guaranteed "
    "one-per-tick correction token)",
)
SPEC_DISABLED = REGISTRY.counter(
    "petals_spec_disabled_total",
    "Lanes auto-disabled from speculation after their acceptance-rate EMA "
    "fell below PETALS_TPU_SPEC_MIN_ACCEPT (cooldown fallback to plain decode)",
)

# --- pool / scheduler ------------------------------------------------------
PAGES_FREE = REGISTRY.gauge(
    "petals_page_pool_free_pages", "Free pages in the paged KV pool"
)
PAGES_TOTAL = REGISTRY.gauge(
    "petals_page_pool_pages", "Total pages in the paged KV pool"
)
LANES_BUSY = REGISTRY.gauge(
    "petals_lanes_busy", "Lanes currently held by sessions"
)
SWAP_BYTES = REGISTRY.counter(
    "petals_swap_bytes_total",
    "KV bytes moved through the host-RAM swap tier",
    labels=("direction",),  # out | in
)
PREEMPTIONS = REGISTRY.counter(
    "petals_preemptions_total", "Sessions preempted (swap-out committed)"
)
ALLOC_FAILED = REGISTRY.counter(
    "petals_allocation_failed_total",
    "AllocationFailed raised to a session (lane or page exhaustion)",
)

# --- client ----------------------------------------------------------------
ROUTE_BUILDS = REGISTRY.counter(
    "petals_client_route_builds_total",
    "Client routing chains built, by mode",
    labels=("mode",),
)
PEER_BANS = REGISTRY.counter(
    "petals_client_peer_bans_total", "Peers banned after request failures"
)
CONGESTION_PENALTIES = REGISTRY.counter(
    "petals_client_congestion_penalties_total",
    "Soft routing penalties applied to queue-dominated servers (hop blame)",
)

# --- compiled-program observatory ------------------------------------------
COMPILES = REGISTRY.counter(
    "petals_compiles_total",
    "XLA compilations observed by tracked_jit, by function name",
    labels=("fn",),  # static code-defined names (observatory.tracked_jit)
)
COMPILE_SECONDS = REGISTRY.counter(
    "petals_compile_seconds_total",
    "Wall seconds spent in calls that triggered a compilation (trace + "
    "compile + first dispatch), by function name",
    labels=("fn",),
)
COMPILE_ANOMALIES = REGISTRY.counter(
    "petals_compile_anomalies_total",
    "Post-warmup compilations of steady-state-tagged functions (the "
    "recompile sentinel firing), by function name",
    labels=("fn",),
)
COMPILED_FLOPS = REGISTRY.gauge(
    "petals_compiled_program_flops",
    "XLA cost_analysis flops of the largest analyzed program, by function",
    labels=("fn",),
)
COMPILED_BYTES = REGISTRY.gauge(
    "petals_compiled_program_bytes_accessed",
    "XLA cost_analysis bytes accessed of the largest analyzed program",
    labels=("fn",),
)

# --- page-pool economics ----------------------------------------------------
PAGE_FREE_RUNS = REGISTRY.gauge(
    "petals_page_pool_free_runs",
    "Free-run histogram of the paged KV pool (contiguous free-page runs "
    "bucketed by length)",
    labels=("bucket",),  # 1 | 2_3 | 4_7 | 8_15 | 16_plus
)
PAGE_FRAGMENTATION = REGISTRY.gauge(
    "petals_page_pool_fragmentation",
    "1 - largest_free_run / free_pages (0 = one contiguous hole, ->1 = "
    "shattered free space)",
)
PAGE_LARGEST_RUN = REGISTRY.gauge(
    "petals_page_pool_largest_free_run",
    "Length of the largest contiguous free-page run",
)
HBM_HEADROOM = REGISTRY.gauge(
    "petals_hbm_headroom_bytes",
    "MemoryCache budget minus live KV bytes (0 when the cache is unbounded)",
)
SWAP_RESIDENCY_OLDEST = REGISTRY.gauge(
    "petals_swap_residency_oldest_seconds",
    "Age of the oldest KV entry currently resident in the host swap tier",
)
PREFIX_EVENTS = REGISTRY.counter(
    "petals_prefix_cache_events_total",
    "Prefix-cache economics: probe hits/misses, page adoptions, and the "
    "radix tree's tier transitions (demote/promote between host and the "
    "swap tier, device_evict for dropped HBM refs, swap_evict and evict "
    "for removed nodes)",
    labels=("event",),  # hit | miss | adopt | evict | device_evict | demote | promote | swap_evict
)

# --- migration / chaos ------------------------------------------------------
MIGRATIONS = REGISTRY.counter(
    "petals_migrations_total",
    "Peer-to-peer session migrations, by direction and outcome",
    labels=("direction", "outcome"),  # out|in x ok|failed|refused|aborted
)
MIGRATION_BYTES = REGISTRY.counter(
    "petals_migration_bytes_total",
    "KV bytes moved server-to-server by session migration",
    labels=("direction",),  # out | in
)
HANDOFFS = REGISTRY.counter(
    "petals_handoffs_total",
    "Disaggregated prefill->decode KV handoffs over the page-push path, "
    "by outcome",
    labels=("outcome",),  # ok | failed | refused | aborted
)
HANDOFF_BYTES = REGISTRY.counter(
    "petals_handoff_bytes_total",
    "KV bytes pushed prefill->decode by phase-tier handoff (also billed "
    "as migration bytes in the per-tenant ledger)",
)
CHAOS_INJECTIONS = REGISTRY.counter(
    "petals_chaos_injections_total",
    "Faults injected by the chaos plane, by site and action",
    labels=("site", "action"),  # sites/actions are static code-defined enums
)

# --- autoscaler -------------------------------------------------------------
AUTOSCALE_DECISIONS = REGISTRY.counter(
    "petals_autoscaler_decisions_total",
    "Autoscaler decisions issued, by action",
    labels=("action",),  # scale_out | scale_in | resize
)
AUTOSCALE_APPLY_FAILED = REGISTRY.counter(
    "petals_autoscaler_apply_failed_total",
    "Autoscaler decisions whose actuator raised (the decision is journaled "
    "with the error; the controller retries after the cooldown)",
)
AUTOSCALE_HOT_STREAK = REGISTRY.gauge(
    "petals_autoscaler_hot_streak_ticks",
    "Consecutive controller ticks the swarm has been over its hot threshold",
)
AUTOSCALE_REPLICAS = REGISTRY.gauge(
    "petals_autoscaler_observed_replicas",
    "ONLINE replicas in the autoscaler's last swarm snapshot",
)

# --- resource ledger --------------------------------------------------------
# Aggregate-only: per-peer breakdowns live in the ledger's bounded dicts and
# its /ledger JSON view, NEVER in metric labels (peer ids are unbounded and
# request-adjacent).
LEDGER_PAGE_SECONDS = REGISTRY.counter(
    "petals_ledger_page_seconds_total",
    "HBM page-seconds attributed to sessions by the resource ledger "
    "(fractional COW attribution; excludes unattributed prefix-cache pins)",
)
LEDGER_UNATTRIBUTED_PAGE_SECONDS = REGISTRY.counter(
    "petals_ledger_unattributed_page_seconds_total",
    "HBM page-seconds held by prefix-cache pins with no live lane reference",
)
LEDGER_COMPUTE_SECONDS = REGISTRY.counter(
    "petals_ledger_compute_seconds_total",
    "Compute-seconds split across lanes per batched tick by the ledger",
)
LEDGER_SESSIONS = REGISTRY.gauge(
    "petals_ledger_live_sessions", "Sessions currently metered by the ledger"
)
LEDGER_PEERS = REGISTRY.gauge(
    "petals_ledger_peers", "Distinct peers the ledger has attributed usage to"
)
LEDGER_PEER_OVERFLOW = REGISTRY.counter(
    "petals_ledger_peer_overflow_total",
    "Sessions collapsed into the shared _overflow peer after the ledger's "
    "peer-cardinality cap (the registry's overflow discipline, applied here)",
)
LEDGER_NOISY_NEIGHBORS = REGISTRY.counter(
    "petals_ledger_noisy_neighbor_total",
    "Noisy-neighbor detections: a peer over its dominant-resource share "
    "while other peers' admissions queued",
)
LEDGER_CACHE_BYTE_SECONDS = REGISTRY.counter(
    "petals_ledger_cache_byte_seconds_total",
    "Prefix-cache residency (bytes held across all tiers, integrated over "
    "wall time) attributed to tenants by the resource ledger — a separate "
    "channel from page-seconds, so the pool conservation invariant is "
    "untouched; per-tenant breakdowns live in the /ledger JSON view",
)

# --- integrity observatory --------------------------------------------------
# Digests themselves NEVER label a metric (unbounded cardinality) — they ride
# journal/flight evidence and the /integrity JSON view instead.
INTEGRITY_DIVERGENCE = REGISTRY.counter(
    "petals_integrity_divergence_total",
    "Activation-fingerprint divergences detected, by detection source",
    labels=("source",),  # client | canary | continuity
)
INTEGRITY_PROBES = REGISTRY.counter(
    "petals_integrity_probes_total",
    "Canary probes issued against span replicas, by outcome",
    labels=("outcome",),  # ok | divergent | error
)
INTEGRITY_QUARANTINED = REGISTRY.gauge(
    "petals_integrity_quarantined_peers",
    "Peers currently quarantined by the integrity observatory",
)
INTEGRITY_PENALTIES = REGISTRY.counter(
    "petals_client_integrity_penalties_total",
    "Hard routing penalties applied to integrity-divergent servers",
)

# --- telemetry self-observation -------------------------------------------
META_TRUNCATED = REGISTRY.counter(
    "telemetry_meta_truncated_total",
    "Span metadata entries dropped or clipped by the size cap",
)
ANNOUNCE_TRUNCATED = REGISTRY.counter(
    "telemetry_announce_truncated_total",
    "DHT announce payloads clipped by the telemetry/integrity size cap",
)

# Pre-resolved children for the per-tick paths (one dict lookup saved).
STEP_DENSE = STEP_DURATION.labels(variant="dense")
STEP_PAGED = STEP_DURATION.labels(variant="paged")
STEP_MIXED = STEP_DURATION.labels(variant="mixed")
STEP_GEN = STEP_DURATION.labels(variant="gen")
STEP_SPEC = STEP_DURATION.labels(variant="spec")
STEPS_DENSE = BATCHED_STEPS.labels(variant="dense")
STEPS_PAGED = BATCHED_STEPS.labels(variant="paged")
STEPS_MIXED = BATCHED_STEPS.labels(variant="mixed")
STEPS_GEN = BATCHED_STEPS.labels(variant="gen")
STEPS_SPEC = BATCHED_STEPS.labels(variant="spec")
SWAP_OUT_BYTES = SWAP_BYTES.labels(direction="out")
SWAP_IN_BYTES = SWAP_BYTES.labels(direction="in")
PREFIX_HIT = PREFIX_EVENTS.labels(event="hit")
PREFIX_MISS = PREFIX_EVENTS.labels(event="miss")
PREFIX_ADOPT = PREFIX_EVENTS.labels(event="adopt")
PREFIX_EVICT = PREFIX_EVENTS.labels(event="evict")
PREFIX_DEVICE_EVICT = PREFIX_EVENTS.labels(event="device_evict")
PREFIX_DEMOTE = PREFIX_EVENTS.labels(event="demote")
PREFIX_PROMOTE = PREFIX_EVENTS.labels(event="promote")
PREFIX_SWAP_EVICT = PREFIX_EVENTS.labels(event="swap_evict")
FREE_RUN_BUCKETS = ("1", "2_3", "4_7", "8_15", "16_plus")
PAGE_FREE_RUN_CHILDREN = {
    b: PAGE_FREE_RUNS.labels(bucket=b) for b in FREE_RUN_BUCKETS
}
