"""Intra-server tensor parallelism (petals_tpu/parallel without the meshes):
one process holds a span split Megatron-style over a list of devices, one
shard per entry, and sums the shards' partial outputs itself."""

from petals_tpu_torch.parallel.collectives import reduce_shards
from petals_tpu_torch.parallel.mesh import tp_devices
from petals_tpu_torch.parallel.tp import ShardedCache, shard_span_params, span_param_specs

__all__ = ["tp_devices", "span_param_specs", "shard_span_params", "reduce_shards", "ShardedCache"]
