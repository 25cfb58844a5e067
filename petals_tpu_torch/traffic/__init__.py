"""Deterministic traffic plane: seeded open-loop load for swarm tests.

:mod:`petals_tpu_torch.traffic.generator` turns a seed into a fixed arrival
schedule — diurnal load waves (nonhomogeneous Poisson via thinning),
heavy-tailed session lengths (truncated Pareto), and an N-tenant prompt
mix with shared per-tenant prefixes (so the prefix cache sees realistic
reuse). The schedule is pure data: the same seed always yields the same
sessions (petals_tpu's schedule for the same seed and config), so two
servers driven by it can be held to the same tokens.

:mod:`petals_tpu_torch.traffic.runner` replays a schedule OPEN-LOOP against
real client sessions (thread per session, arrivals never wait on
completions — a slow swarm gets more concurrent load, like real users).
Compose with ``PETALS_TPU_CHAOS`` to add faults under the wave.
"""

from petals_tpu_torch.traffic.generator import SessionPlan, TrafficConfig, TrafficGenerator
from petals_tpu_torch.traffic.runner import SessionResult, run_schedule

__all__ = [
    "SessionPlan",
    "SessionResult",
    "TrafficConfig",
    "TrafficGenerator",
    "run_schedule",
]
