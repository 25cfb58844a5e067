"""The port's client: routing over a swarm, inference sessions with
failover, generation, and training of prompts through the swarm
(petals_tpu/client)."""

from petals_tpu_torch.client.config import ClientConfig
from petals_tpu_torch.client.inference_session import InferenceSession
from petals_tpu_torch.client.model import (
    AutoDistributedModel,
    AutoDistributedModelForCausalLM,
    AutoDistributedModelForSequenceClassification,
    DistributedModel,
    DistributedModelForCausalLM,
    DistributedModelForSequenceClassification,
    DistributedModelForSpeculativeGeneration,
)
from petals_tpu_torch.client.ptune import PTuneConfig
from petals_tpu_torch.client.remote_sequential import RemoteSequential

__all__ = [
    "AutoDistributedModel",
    "AutoDistributedModelForCausalLM",
    "AutoDistributedModelForSequenceClassification",
    "ClientConfig",
    "DistributedModel",
    "DistributedModelForCausalLM",
    "DistributedModelForSequenceClassification",
    "DistributedModelForSpeculativeGeneration",
    "InferenceSession",
    "PTuneConfig",
    "RemoteSequential",
]
