"""Tensor-parallel splits of a span's weights and KV buffers (the port of
petals_tpu/parallel/tp.py). Megatron-style, as the JAX package's
PartitionSpecs: the attention and MLP input projections split on their
output (head / FFN) axis, the output projections on their input axis, norms
and the router are replicated, and Mixtral's experts split on the expert
axis. The replicated biases ``bo`` / ``b_down`` / ``bd`` are added once,
after the reduction of the shards' partial sums (parallel/collectives.py),
never on each shard.

The port holds a span as one parameter dict a block. ``span_param_specs``
names, for each leaf of one block, the axis that splits (counted from the
end: -1 the output axis of an [in, out] weight, -2 its input axis, -3 the
expert axis of an [E, in, out] stack) or None for a replicated leaf.
``shard_span_params`` turns the blocks into one dict a shard for each, each
leaf a contiguous copy of its part on its shard's device.

``ShardedCache`` is a dense KV buffer [..., hkv, d] held as one tensor a
shard, each with its hkv / N heads on its shard's device (the JAX
package's ``kv_cache_pspec``), and under sequence parallelism one such
split a sp rank, a tensor shared where ranks share a device (replicated
over "sp"). Indexing the leading axes indexes every shard; reading it to
the host or copying it out joins the shards along the head axis, and
writing a whole tensor into it splits that tensor into every copy: a
tensor- or sequence-parallel session's KV bytes are an unsharded
server's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from petals_tpu_torch.ops.quant import NF4_BLOCK, OutlierQuantLinear, QuantizedLinear

OUT, IN, EXPERT = -1, -2, -3  # split axes, from the end of a leaf's shape
HEAD_AXIS = -2  # the kv-head axis of a cache buffer [..., hkv, d]


def span_param_specs(family_name: str, cfg) -> Dict[str, Optional[int]]:
    """The split axis of each leaf of one block of ``family_name`` (None:
    replicated). Raises KeyError for a family without a spec, as the JAX
    package does: Mistral, Qwen2, Gemma, Gemma-2 and Phi-3 have none."""
    if family_name == "llama":
        specs = {"ln1": None, "wq": OUT, "wk": OUT, "wv": OUT, "wo": IN, "ln2": None, "wg": OUT, "wu": OUT,
                 "wd": IN}
        if getattr(cfg, "attention_bias", False):
            specs.update(bq=OUT, bk=OUT, bv=OUT, bo=None)
        if getattr(cfg, "mlp_bias", False):
            specs.update(bg=OUT, bu=OUT, bd=None)
        return specs
    if family_name == "bloom":
        return {"ln1_w": None, "ln1_b": None, "wq": OUT, "bq": OUT, "wk": OUT, "bk": OUT, "wv": OUT, "bv": OUT,
                "wo": IN, "bo": None, "ln2_w": None, "ln2_b": None, "w_up": OUT, "b_up": OUT, "w_down": IN,
                "b_down": None}
    if family_name == "falcon":
        specs = {"wq": OUT, "wk": OUT, "wv": OUT, "wo": IN, "w_up": OUT, "w_down": IN}
        if cfg.new_decoder_architecture and cfg.num_ln_in_parallel_attn == 2:
            specs.update(ln_attn_w=None, ln_attn_b=None, ln_mlp_w=None, ln_mlp_b=None)
        else:
            specs.update(ln1_w=None, ln1_b=None)
            if not cfg.parallel_attn and not cfg.new_decoder_architecture:
                specs.update(ln2_w=None, ln2_b=None)
        if cfg.bias:
            specs.update(bq=OUT, bk=OUT, bv=OUT, bo=None, b_up=OUT, b_down=None)
        return specs
    if family_name == "mixtral":
        return {"ln1": None, "wq": OUT, "wk": OUT, "wv": OUT, "wo": IN, "ln2": None, "gate": None,
                "w1": EXPERT, "w2": EXPERT, "w3": EXPERT}
    raise KeyError(f"No TP spec for family {family_name!r}")


def quant_leaf_specs(leaf: QuantizedLinear, axis: Optional[int]):
    """(data axis, scales axis) of a quantized leaf whose dense weight
    splits on ``axis`` (``quant_leaf_pspecs``): int8 data [..., in, out]
    splits as the dense weight and its scales [..., out] drop the input
    axis; packed 4-bit data [..., in/2, out] and its absmax scales
    [..., in/64, out] both follow the dense split, so an input-axis split
    lands whole 64-row blocks on each shard. An input-axis split takes the
    logical rows (``_shard_leaf``): where the stored layout pads the input
    axis (to 1024 rows), the JAX package's shards split the padded array,
    whose parts then differ from the port's; without padding they are the
    same bytes."""
    if axis is None or leaf.kind != "int8":
        return axis, axis
    return axis, (None if axis == IN else axis if axis == OUT else axis + 1)


def validate_tp_divisibility(blocks: Sequence[dict], tp_size: int, specs: Dict[str, Optional[int]], *,
                             num_kv_heads: Optional[int] = None) -> None:
    """Fail fast, with the JAX package's messages, where a split would not
    be whole: the kv heads, each split axis, and a packed 4-bit leaf's
    absmax blocks under an input-axis split. ``dim`` in a message counts
    from the span-stacked layout's block axis, as the JAX package's does."""
    if tp_size == 1:
        return
    if num_kv_heads is not None and num_kv_heads % tp_size != 0:
        raise ValueError(
            f"num_key_value_heads={num_kv_heads} is not divisible by the tensor-"
            f"parallel axis size {tp_size}; use a smaller tp mesh for this model"
        )
    for name, leaf in blocks[0].items():
        axis = specs[name]
        if axis is None:
            continue
        shape = tuple(leaf.shape)  # a quantized leaf's shape is the logical [..., in, out]
        dim = len(shape) + axis
        if shape[dim] % tp_size != 0:
            raise ValueError(
                f"Parameter {name!r} dim {dim + 1} (size {shape[dim]}) is not "
                f"divisible by the tensor-parallel axis size {tp_size}"
            )
        if isinstance(leaf, QuantizedLinear) and leaf.kind in ("nf4", "nf4a", "int4") and axis == IN:
            # whole LOGICAL blocks: a shard multiplies its own slice of the
            # input, so its rows are the logical ones, never the stored
            # layout's zero padding (the JAX package counts stored blocks)
            blocks_ = leaf.in_features // NF4_BLOCK
            if leaf.in_features % NF4_BLOCK or blocks_ % tp_size != 0:
                raise ValueError(
                    f"{leaf.kind} parameter {name!r} has {blocks_} absmax blocks, "
                    f"not divisible by the tensor-parallel axis size {tp_size}"
                )


def _part(t: torch.Tensor, axis: Optional[int], rank: int, n: int, device: torch.device) -> torch.Tensor:
    """Part ``rank`` of ``n`` of ``t`` along ``axis`` as a contiguous copy on
    ``device`` (a replicated leaf is moved, shared where it already lies)."""
    if axis is None:
        return t.to(device)
    size = t.shape[axis] // n
    return t.narrow(axis, rank * size, size).to(device=device, copy=True, memory_format=torch.contiguous_format)


def _rows(t: torch.Tensor, rank: int, rows: int, device: torch.device) -> torch.Tensor:
    """Rows [rank * rows, (rank + 1) * rows) of the input axis (-2) of
    ``t``, a contiguous copy on ``device``."""
    return t.narrow(IN, rank * rows, rows).to(device=device, copy=True, memory_format=torch.contiguous_format)


def _shard_leaf(leaf, axis: Optional[int], rank: int, n: int, device: torch.device):
    if isinstance(leaf, QuantizedLinear):
        data_axis, scales_axis = quant_leaf_specs(leaf, axis)
        in_f, out_f = leaf.in_features, leaf.out_features
        if axis == IN:
            # the logical rows (a packed leaf: two a byte, 64 a scale row);
            # a stored layout zero-padded past in_features keeps its padding
            # out of every shard
            in_f //= n
            if leaf.kind == "int8":
                return QuantizedLinear(leaf.kind, _rows(leaf.data, rank, in_f, device),
                                       _part(leaf.scales, None, rank, n, device), in_f, out_f)
            return QuantizedLinear(leaf.kind, _rows(leaf.data, rank, in_f // 2, device),
                                   _rows(leaf.scales, rank, in_f // NF4_BLOCK, device), in_f, out_f)
        if axis == OUT:
            out_f //= n
        return QuantizedLinear(leaf.kind, _part(leaf.data, data_axis, rank, n, device),
                               _part(leaf.scales, scales_axis, rank, n, device), in_f, out_f)
    return _part(leaf, axis, rank, n, device)


def shard_span_params(blocks: Sequence[dict], devices: Sequence[torch.device], family_name: str,
                      cfg, *, n_shards: Optional[int] = None, first: int = 0) -> List[List[dict]]:
    """One dict a shard for each block of ``blocks`` (per-block dicts):
    ``out[i][s]`` is block i's part on ``devices[s]``. Refuses the outlier
    kinds (their side arrays have no split) with NotImplementedError and,
    before anything is copied, any split that is not whole
    (``validate_tp_divisibility``). Across processes ``devices`` holds
    shards [first, first + len(devices)) of a split into ``n_shards``."""
    if any(isinstance(leaf, OutlierQuantLinear) for b in blocks for leaf in b.values()):
        raise NotImplementedError(
            "outlier-augmented quantization ('+o' kinds) does not compose "
            "with tensor-parallel meshes yet — the outlier side arrays have "
            "no PartitionSpecs; use the base kind (nf4a/int4) under TP"
        )
    specs = span_param_specs(family_name, cfg)
    n = len(devices) if n_shards is None else int(n_shards)
    validate_tp_divisibility(blocks, n, specs,
                             num_kv_heads=getattr(cfg, "num_key_value_heads", cfg.num_attention_heads))
    return [[{name: _shard_leaf(leaf, specs[name], first + s, n, torch.device(dev)) for name, leaf in b.items()}
             for s, dev in enumerate(devices)] for b in blocks]


def is_sharded(params) -> bool:
    """Whether one block's ``params`` is a list of shard dicts."""
    return isinstance(params, (list, tuple))


class ShardedCache:
    """A dense KV buffer [..., hkv, d] split over shards along the head axis:
    ``shards[s]`` holds heads [s * hkv / N, (s + 1) * hkv / N) on its own
    device. Under sequence parallelism the buffer is also replicated over
    the sp ranks: ``ranks[r]`` is rank r's list of shard tensors, on that
    rank's devices, and ``shards`` is rank 0's. Ranks whose shard lies on one
    device share that tensor (one copy a distinct device: on one card the
    ranks hold one buffer); every distinct copy holds the same bytes. It
    answers the handful of tensor operations the serving path applies to a
    dense cache: indexing of the leading axes (every copy, views),
    ``clone``, ``zero_``, ``copy_`` of a whole tensor (split, into every
    copy) or of another ShardedCache, ``index_select`` on a leading axis,
    and reads out (``cpu``, ``to``, ``join``) that join rank 0's shards.
    Across processes it holds this process's shards only: heads
    [head_offset, head_offset + local heads) of ``total_heads``; ``shape``
    is the logical buffer's, a whole tensor written in gives each shard its
    own heads, and a read out joins the local heads (the whole buffer is
    gathered by parallel/multihost.py's export)."""

    def __init__(self, shards: Optional[Sequence[torch.Tensor]] = None,
                 ranks: Optional[Sequence[Sequence[torch.Tensor]]] = None, *, total_heads: Optional[int] = None,
                 head_offset: int = 0, n_sp: Optional[int] = None):
        self.ranks = [list(r) for r in ranks] if ranks is not None else [list(shards)]
        # across processes: the global heads, where this process's start,
        # and how many sp ranks of the global grid the buffer is replicated over
        self.total_heads, self.head_offset, self.n_sp = total_heads, head_offset, n_sp

    @property
    def shards(self) -> List[torch.Tensor]:
        return self.ranks[0]

    def distinct(self) -> List[torch.Tensor]:
        """Every distinct tensor of the copies, once each."""
        seen = {}
        for r in self.ranks:
            for t in r:
                seen.setdefault(id(t), t)
        return list(seen.values())

    def _map(self, fn) -> "ShardedCache":
        """``fn`` of each distinct tensor, computed once, the sharing kept."""
        done = {}
        for r in self.ranks:
            for t in r:
                if id(t) not in done:
                    done[id(t)] = fn(t)
        return ShardedCache(ranks=[[done[id(t)] for t in r] for r in self.ranks], total_heads=self.total_heads,
                            head_offset=self.head_offset, n_sp=self.n_sp)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[HEAD_AXIS] = self.total_heads or sum(t.shape[HEAD_AXIS] for t in self.shards)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def dim(self) -> int:
        return self.shards[0].dim()

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def data_ptr(self) -> int:
        return self.shards[0].data_ptr()

    def __getitem__(self, idx) -> "ShardedCache":
        n_idx = len(idx) if isinstance(idx, tuple) else 1
        if n_idx > self.dim() - 2 or idx is Ellipsis or (isinstance(idx, tuple) and Ellipsis in idx):
            raise IndexError("a ShardedCache indexes its leading axes only, never the head or head-dim axes")
        return self._map(lambda t: t[idx])

    def clone(self) -> "ShardedCache":
        return self._map(torch.Tensor.clone)

    def zero_(self) -> "ShardedCache":
        for t in self.distinct():
            t.zero_()
        return self

    def index_select(self, dim: int, index: torch.Tensor) -> "ShardedCache":
        if dim % self.dim() >= self.dim() - 2:
            raise IndexError("index_select on the head or head-dim axis of a ShardedCache")
        return self._map(lambda t: t.index_select(dim, index.to(t.device)))

    def copy_(self, src) -> "ShardedCache":
        """Write ``src`` (a ShardedCache of the same head split, or a tensor
        of this logical shape) into every distinct copy; a ShardedCache of
        as many ranks is copied rank to rank, else from its rank 0."""
        done = set()
        for r, shards in enumerate(self.ranks):
            off = self.head_offset
            for s, t in enumerate(shards):
                if id(t) not in done:
                    done.add(id(t))
                    if isinstance(src, ShardedCache):
                        part = (src.ranks[r] if len(src.ranks) == len(self.ranks) else src.shards)[s]
                    else:
                        part = src.narrow(HEAD_AXIS, off, t.shape[HEAD_AXIS])
                    t.copy_(part.to(t.device))
                off += t.shape[HEAD_AXIS]
        return self

    def join(self, device=None) -> torch.Tensor:
        """The logical tensor, rank 0's shards concatenated along the head
        axis, on ``device`` (default: shard 0's)."""
        device = self.device if device is None else torch.device(device)
        return torch.cat([t.to(device) for t in self.shards], dim=HEAD_AXIS)

    def cpu(self) -> torch.Tensor:
        return self.join("cpu")

    def to(self, device=None, dtype: Optional[torch.dtype] = None, copy: bool = False) -> torch.Tensor:
        """The joined tensor on ``device`` in ``dtype`` (a fresh tensor: the
        join copies)."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        out = self.join(device)
        return out if dtype is None else out.to(dtype)


class ShardedDescriptor:
    """A ``TensorDescriptor`` of a ShardedCache: the logical shape, budgeted
    at its whole bytes, made as one zero tensor a shard and a distinct
    device. ``devices`` lists the shards' devices; with ``num_sp`` > 1 it is
    the tp x sp grid in ``serving_devices``' order (entry t * num_sp + r:
    shard t of rank r), and a shard whose ranks share a device is one
    tensor."""

    def __init__(self, shape, dtype: torch.dtype, devices: Sequence[torch.device], num_sp: int = 1, *,
                 n_shards: Optional[int] = None, first: int = 0, total_sp: Optional[int] = None):
        """Across processes ``devices`` holds shards [first, first + n_t) of
        a split of the heads into ``n_shards``, and the buffer is replicated
        over ``total_sp`` ranks of the global grid."""
        devices = [torch.device(d) for d in devices]
        n = len(devices) // num_sp
        self.n_shards = n if n_shards is None else int(n_shards)
        if shape[HEAD_AXIS] % self.n_shards:
            raise ValueError(f"{shape[HEAD_AXIS]} kv heads do not split over {self.n_shards} shards")
        self.first, self.total_sp = first, total_sp
        self.shape, self.dtype, self.num_sp = tuple(shape), dtype, num_sp
        # grid[r][t]: shard t's device on rank r
        self.grid = [[devices[t * num_sp + r] for t in range(n)] for r in range(num_sp)]
        self.devices = self.grid[0]

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def make_zeros(self) -> ShardedCache:
        part = list(self.shape)
        part[HEAD_AXIS] //= self.n_shards
        made = {}
        for row in self.grid:
            for t, d in enumerate(row):
                if (t, d) not in made:
                    made[(t, d)] = torch.zeros(part, dtype=self.dtype, device=d)
        ranks = [[made[(t, d)] for t, d in enumerate(row)] for row in self.grid]
        if self.total_sp is None:
            return ShardedCache(ranks=ranks)
        return ShardedCache(ranks=ranks, total_heads=self.shape[HEAD_AXIS], head_offset=self.first * part[HEAD_AXIS],
                            n_sp=self.total_sp)
