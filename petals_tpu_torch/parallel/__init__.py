"""Intra-server parallelism (petals_tpu/parallel without the meshes): one
process holds a span split Megatron-style over a list of devices, one shard
per entry, and sums the shards' partial outputs itself (tensor
parallelism); over a tp x sp grid it also splits each chunk's rows over sp
ranks that meet in attention (sequence parallelism, parallel/sp.py)."""

from petals_tpu_torch.parallel.collectives import reduce_shards
from petals_tpu_torch.parallel.mesh import serving_devices, tp_devices
from petals_tpu_torch.parallel.sp import GridParams
from petals_tpu_torch.parallel.tp import ShardedCache, shard_span_params, span_param_specs

__all__ = ["tp_devices", "serving_devices", "span_param_specs", "shard_span_params", "reduce_shards",
           "ShardedCache", "GridParams"]
