"""Closed-loop swarm elasticity: the autoscaler policy and controller.

:mod:`petals_tpu_torch.swarm.policy` is a PURE deterministic decision function
over swarm-aggregate snapshots (no I/O, no clocks, no randomness) —
that's what makes decisions replayable and their journals byte-identical
across runs. :mod:`petals_tpu_torch.swarm.autoscaler` wraps it in a controller
that samples a live swarm (via :class:`~petals_tpu_torch.utils.health.HealthMonitor`
state), journals every decision with its evidence, and hands decisions to
a pluggable actuator: shell commands (``python -m
petals_tpu_torch.cli.run_autoscaler`` against a real swarm), or
``server_actuator``, whose resize moves an in-process port server's span.
The policy is petals_tpu's (petals_tpu/swarm/): the same snapshots give
byte-equal journals.
"""

from petals_tpu_torch.swarm.autoscaler import Autoscaler, CallbackActuator, server_actuator
from petals_tpu_torch.swarm.policy import (
    AutoscalerPolicy,
    Decision,
    PolicyConfig,
    ServerSample,
    SwarmSnapshot,
)

__all__ = [
    "Autoscaler",
    "AutoscalerPolicy",
    "CallbackActuator",
    "Decision",
    "PolicyConfig",
    "ServerSample",
    "SwarmSnapshot",
    "server_actuator",
]
