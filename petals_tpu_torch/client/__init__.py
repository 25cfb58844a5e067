"""The port's client: routing over a swarm, inference sessions with
failover, and generation (petals_tpu/client)."""

from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.inference_session import InferenceSession
from petals_tpu_torch.client.model import (
    AutoDistributedModel,
    AutoDistributedModelForCausalLM,
    DistributedModel,
    DistributedModelForCausalLM,
)
from petals_tpu_torch.client.remote_sequential import RemoteSequential

__all__ = [
    "AutoDistributedModel",
    "AutoDistributedModelForCausalLM",
    "ClientConfig",
    "DistributedModel",
    "DistributedModelForCausalLM",
    "InferenceSession",
    "RemoteSequential",
]
