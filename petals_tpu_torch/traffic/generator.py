"""Seeded traffic generator: seed -> deterministic session schedule.

Models the shape of public-swarm load without owning production traffic:

- **Diurnal wave**: arrivals follow a nonhomogeneous Poisson process with
  rate ``base_rate * (1 + wave_amplitude * sin(2*pi*t/wave_period_s))``,
  sampled by Lewis-Shedler thinning (draw from the peak rate, keep each
  arrival with probability rate(t)/peak) — exact for any bounded rate
  function and trivially deterministic under a seeded RNG.
- **Heavy-tailed sessions**: decode lengths draw from a truncated Pareto
  (most sessions short, a few very long — the distribution that actually
  stresses lane occupancy and the swap tier).
- **N-tenant prompt mix**: each tenant owns a fixed prompt prefix (drawn
  once from the seed) plus a per-session random suffix, so the prefix
  cache sees realistic reuse and the ledger sees distinct tenants.
- **Prompt trees** (optional, ``tree_branching``): real multi-tenant
  prompts nest — a swarm-shared system prompt, a per-tenant tool
  preamble, then branching few-shot variants, then the random user turn.
  With ``tree_branching=(b0, b1, ...)`` each session walks one path
  through a per-tenant tree of content segments (level ``i`` picks among
  ``b_i`` children), so prompts share progressively shorter prefixes the
  deeper they diverge — exactly the workload a radix prefix tree exploits
  and a flat LRU thrashes on. ``tree_hot_bias`` skews path choice toward
  child 0 at every level, creating one hot lineage and a cold bushy rest.

Everything derives from one ``random.Random(seed)`` in a fixed draw
order; the schedule is pure data (no wall clock anywhere). The tree
fields draw NOTHING when disabled, so legacy seeds reproduce exactly.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Tuple

__all__ = ["SessionPlan", "TrafficConfig", "TrafficGenerator"]


@dataclasses.dataclass(frozen=True)
class SessionPlan:
    """One scheduled session: arrive at ``t`` (seconds from run start),
    send ``prompt``, decode ``new_tokens`` greedily."""

    index: int
    t: float
    tenant: int
    prompt: Tuple[int, ...]  # token ids
    new_tokens: int
    path: Tuple[int, ...] = ()  # branch chosen at each tree level (tree mode)
    storm: bool = False  # arrived via the prefill_storm overlay


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    seed: int = 0
    duration_s: float = 60.0
    base_rate: float = 0.5  # mean arrivals/s at wave midline
    wave_amplitude: float = 0.8  # 0 = flat, 1 = rate swings to zero at trough
    wave_period_s: float = 60.0  # one "day" of the diurnal cycle
    tenants: int = 3
    prompt_prefix_len: int = 4  # shared per-tenant prefix (prefix-cache reuse)
    prompt_suffix_len: int = 3  # per-session random tail
    vocab_size: int = 1000
    min_new_tokens: int = 2  # Pareto x_m (scale)
    max_new_tokens: int = 16  # truncation cap (keeps CPU benches bounded)
    pareto_alpha: float = 1.5  # tail index; <2 = heavy tail, infinite variance
    # prompt trees: () keeps flat prompts (and the legacy RNG stream)
    shared_prefix_len: int = 0  # swarm-shared system prompt before the tenant prefix
    tree_branching: Tuple[int, ...] = ()  # children per level of the per-tenant tree
    tree_segment_len: int = 0  # tokens per tree-node segment
    tree_hot_bias: float = 0.0  # P(child 0) at each level; rest uniform
    # prefill_storm overlay (disaggregated-serving stress): a second seeded
    # arrival process of BURSTS of heavy-tailed LONG prompts with short
    # decodes — the workload that floods prefill lanes while light decode
    # traffic keeps flowing. ``storm_rate=0`` disables the overlay and
    # draws NOTHING from the RNG, so legacy seeds reproduce byte-identically.
    storm_rate: float = 0.0  # mean burst arrivals/s inside the storm window
    storm_burst: int = 4  # sessions per burst epoch
    storm_start_frac: float = 0.25  # storm window as fractions of duration_s
    storm_end_frac: float = 0.75
    storm_prompt_len: int = 64  # Pareto x_m for the storm prompt length
    storm_prompt_max: int = 256  # truncation cap
    storm_prompt_alpha: float = 1.2  # tail index (heavier than the decode tail)
    storm_new_tokens: int = 4  # short decode: these sessions are prefill-bound

    def __post_init__(self):
        if not 0.0 <= self.wave_amplitude <= 1.0:
            raise ValueError("wave_amplitude must be in [0, 1]")
        if self.base_rate <= 0 or self.duration_s <= 0:
            raise ValueError("base_rate and duration_s must be positive")
        if self.tenants < 1:
            raise ValueError("need at least one tenant")
        if not 1 <= self.min_new_tokens <= self.max_new_tokens:
            raise ValueError("need 1 <= min_new_tokens <= max_new_tokens")
        if self.tree_branching:
            if any(b < 1 for b in self.tree_branching):
                raise ValueError("tree_branching factors must be >= 1")
            if self.tree_segment_len < 1:
                raise ValueError("tree_branching requires tree_segment_len >= 1")
        if not 0.0 <= self.tree_hot_bias <= 1.0:
            raise ValueError("tree_hot_bias must be in [0, 1]")
        if self.shared_prefix_len < 0:
            raise ValueError("shared_prefix_len must be >= 0")
        if self.storm_rate < 0:
            raise ValueError("storm_rate must be >= 0")
        if self.storm_rate > 0:
            if not 0.0 <= self.storm_start_frac < self.storm_end_frac <= 1.0:
                raise ValueError("need 0 <= storm_start_frac < storm_end_frac <= 1")
            if self.storm_burst < 1:
                raise ValueError("storm_burst must be >= 1")
            if not 1 <= self.storm_prompt_len <= self.storm_prompt_max:
                raise ValueError("need 1 <= storm_prompt_len <= storm_prompt_max")
            if self.storm_new_tokens < 1:
                raise ValueError("storm_new_tokens must be >= 1")


class TrafficGenerator:
    def __init__(self, config: TrafficConfig):
        self.config = config

    def rate_at(self, t: float) -> float:
        cfg = self.config
        return cfg.base_rate * (
            1.0 + cfg.wave_amplitude * math.sin(2.0 * math.pi * t / cfg.wave_period_s)
        )

    def schedule(self) -> List[SessionPlan]:
        """The full deterministic schedule for ``duration_s`` seconds."""
        cfg = self.config
        rng = random.Random(cfg.seed)
        # draw order is load-bearing: shared root, then tenant prefixes, then
        # tree segments (tenant-major, depth-first), then the arrival loop —
        # and the tree draws happen ONLY in tree mode, so flat-config seeds
        # keep producing the schedules they always have
        shared = tuple(
            rng.randrange(1, cfg.vocab_size) for _ in range(cfg.shared_prefix_len)
        )
        prefixes = [
            tuple(rng.randrange(1, cfg.vocab_size) for _ in range(cfg.prompt_prefix_len))
            for _ in range(cfg.tenants)
        ]
        trees = [self._draw_tree(rng) for _ in range(cfg.tenants)]
        peak = cfg.base_rate * (1.0 + cfg.wave_amplitude)
        plans: List[SessionPlan] = []
        t = 0.0
        while True:
            # thinning: homogeneous candidate stream at the peak rate...
            t += rng.expovariate(peak)
            if t >= cfg.duration_s:
                break
            # ...accepted with probability rate(t)/peak (draw unconditionally
            # so the RNG stream — and thus the schedule — is reproducible)
            if rng.random() >= self.rate_at(t) / peak:
                continue
            tenant = rng.randrange(cfg.tenants)
            path: Tuple[int, ...] = ()
            tree_tokens: Tuple[int, ...] = ()
            if cfg.tree_branching:
                path = self._draw_path(rng)
                nodes = trees[tenant]
                for depth in range(1, len(path) + 1):
                    tree_tokens += nodes[path[:depth]]
            suffix = tuple(
                rng.randrange(1, cfg.vocab_size) for _ in range(cfg.prompt_suffix_len)
            )
            # truncated Pareto via inverse CDF: x_m * (1-u)^(-1/alpha)
            u = rng.random()
            length = int(cfg.min_new_tokens * (1.0 - u) ** (-1.0 / cfg.pareto_alpha))
            new_tokens = max(cfg.min_new_tokens, min(cfg.max_new_tokens, length))
            plans.append(
                SessionPlan(
                    index=len(plans),
                    t=t,
                    tenant=tenant,
                    prompt=shared + prefixes[tenant] + tree_tokens + suffix,
                    new_tokens=new_tokens,
                    path=path,
                )
            )
        # prefill_storm overlay draws strictly AFTER every legacy draw (and
        # only when enabled), so the legacy portion of the stream — and thus
        # disabled-storm schedules — never shifts
        storm_plans = self._storm_overlay(rng)
        if not storm_plans:
            return plans
        # stable merge by arrival time (legacy plan wins a tie), reindexed
        merged = sorted(plans + storm_plans, key=lambda p: p.t)
        return [dataclasses.replace(p, index=i) for i, p in enumerate(merged)]

    def _storm_overlay(self, rng: random.Random) -> List[SessionPlan]:
        """Burst arrivals of heavy-tailed long prompts inside the storm
        window: burst epochs are a homogeneous Poisson stream at
        ``storm_rate``; each epoch lands ``storm_burst`` sessions at once
        (the thundering-herd shape that queues prefill lanes)."""
        cfg = self.config
        if cfg.storm_rate <= 0:
            return []
        t0 = cfg.storm_start_frac * cfg.duration_s
        t1 = cfg.storm_end_frac * cfg.duration_s
        plans: List[SessionPlan] = []
        t = t0
        while True:
            t += rng.expovariate(cfg.storm_rate)
            if t >= t1:
                break
            for _ in range(cfg.storm_burst):
                tenant = rng.randrange(cfg.tenants)
                # truncated Pareto prompt length (same inverse-CDF form as
                # the decode-length draw, scaled to prompt tokens)
                u = rng.random()
                length = int(
                    cfg.storm_prompt_len * (1.0 - u) ** (-1.0 / cfg.storm_prompt_alpha)
                )
                plen = max(cfg.storm_prompt_len, min(cfg.storm_prompt_max, length))
                prompt = tuple(
                    rng.randrange(1, cfg.vocab_size) for _ in range(plen)
                )
                plans.append(
                    SessionPlan(
                        index=len(plans),
                        t=t,
                        tenant=tenant,
                        prompt=prompt,
                        new_tokens=cfg.storm_new_tokens,
                        storm=True,
                    )
                )
        return plans

    def _draw_tree(self, rng: random.Random) -> dict:
        """One tenant's content tree: ``{path: segment_tokens}`` for every
        node, drawn depth-first child-major so the layout (and thus every
        prompt) is a pure function of the seed."""
        cfg = self.config
        nodes: dict = {}

        def expand(path: Tuple[int, ...]) -> None:
            level = len(path)
            if level == len(cfg.tree_branching):
                return
            for b in range(cfg.tree_branching[level]):
                child = path + (b,)
                nodes[child] = tuple(
                    rng.randrange(1, cfg.vocab_size)
                    for _ in range(cfg.tree_segment_len)
                )
                expand(child)

        if cfg.tree_branching:
            expand(())
        return nodes

    def _draw_path(self, rng: random.Random) -> Tuple[int, ...]:
        """One root-to-leaf walk. ``tree_hot_bias`` concentrates mass on
        child 0 at every level: bias 0 is uniform, bias 1 always takes the
        hot lineage — the knob that turns one subtree hot and the rest
        into cache-thrashing cold bulk."""
        cfg = self.config
        path = []
        for branching in cfg.tree_branching:
            if branching == 1:
                path.append(0)
                continue
            if rng.random() < cfg.tree_hot_bias:
                path.append(0)
            else:
                path.append(rng.randrange(branching))
        return tuple(path)
