"""The work of a step program, in the terms of XLA's ``cost_analysis()``:
``flops``, ``bytes_accessed`` and ``transcendentals``.

The JAX package reads a compiled program's cost from XLA
(petals_tpu/telemetry/observatory.py ``analyze``). A CUDA graph has no such
analysis, and a capture cannot be run again to measure one (it writes
caches), so the port counts the work once, while the capture's own run of
the step function issues it (telemetry/observatory.py ``TrackedGraph``):

- Every aten op is counted by ``OpCounter``, a ``TorchDispatchMode`` that
  reads the shapes and dtypes of the op's operands and outputs, never their
  values (no sync, so a capture stays legal), and calls the op unchanged.
- A hand-written kernel's launch goes through ctypes, where dispatch does not
  see it, so each kernel wrapper reports the work of the function it computes
  (``count_cost``), from a formula in its kernel's module: the launch's
  shapes and arm only.

Conventions, XLA's (HloCostAnalysis on the lowered program):

- a matrix product counts 2 * M * N * K flops (source "dot");
- an elementwise op one flop per output element, a comparison or a select
  too; a cast one;
- exp, log, tanh, rsqrt, sqrt, erf, sin, cos, sigmoid, pow to a non-integer
  exponent and the like count one transcendental per element and no flop;
  sigmoid, silu and gelu count as XLA counts their jax.nn expansions (3, 4
  and 4 flops an element beside the transcendental);
- a reduction counts (input elements - output elements) flops, a mean one
  more per output element;
- bytes are each op's operand bytes plus its output bytes.

Where the two differ in kind, the port counts the bytes an op moves: a
gather (``index``, ``index_select``, ``embedding``, ``gather``) reads its
indices and as many bytes of its source as it writes; an indexed write into
a buffer (``index_put_``, ``index_copy_``, ``scatter_``, ``index_add_``) and a
``copy_`` into a view read their indices and values and write as many bytes
as the values, never the whole buffer; a fused aten op (``_softmax``)
counts its operand and output once where XLA's lowering counts each of its
five ops. Views (``view``, ``expand``, ``permute``, ``slice``, ``select`` and
the rest of ``_FREE``), allocations (``empty*``) and metadata reads count
nothing; a fill (``zeros``, ``full``, ``arange``, ``fill_``, ``zero_``)
counts the bytes it writes. An op with no rule here counts its operand and
output bytes and is named in ``StepCost.unlisted``.

**Shapes only, never data.** A cost is counted once per graph, as XLA's is
once per program, and holds for every replay, so nothing in it may depend on
values that change between replays: the ragged lengths and positions that
live on the card. A kernel counts its work at the capacity its key was
captured for: every lane at its table's full length (within the window), a
chunk at the last rows of its table, every expert at its full weight. XLA
counts the JAX package's plain path the same way, since its gather covers
the whole table.
"""

from __future__ import annotations

import math
from typing import Dict, List, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


class StepCost:
    """flops, bytes and transcendentals, added up by source: "dot" (the
    matrix products dispatch sees), "aten" (every other op), and the name
    each kernel wrapper reports under."""

    __slots__ = ("parts", "unlisted")

    def __init__(self):
        self.parts: Dict[str, List[int]] = {}
        self.unlisted: Set[str] = set()  # ops counted by the fallback rule

    def snapshot(self) -> Dict[str, tuple]:
        return {source: tuple(part) for source, part in self.parts.items()}

    def since(self, snapshot: Dict[str, tuple]) -> Dict[str, tuple]:
        """What was added after ``snapshot``, by source."""
        return {source: tuple(a - b for a, b in zip(part, snapshot.get(source, (0, 0, 0))))
                for source, part in self.parts.items()}

    def merge(self, delta: Dict[str, tuple]) -> None:
        for source, (flops, nbytes, trans) in delta.items():
            self.add(source, flops, nbytes, trans)

    def add(self, source: str, flops: int, nbytes: int, transcendentals: int = 0) -> None:
        part = self.parts.get(source)
        if part is None:
            part = self.parts[source] = [0, 0, 0]
        part[0] += flops
        part[1] += nbytes
        part[2] += transcendentals

    def part(self, source: str) -> dict:
        flops, nbytes, trans = self.parts.get(source, (0, 0, 0))
        return {"flops": float(flops), "bytes_accessed": float(nbytes), "transcendentals": float(trans)}

    def total(self) -> dict:
        """XLA's three fields, summed over every source."""
        return {
            "flops": float(sum(p[0] for p in self.parts.values())),
            "bytes_accessed": float(sum(p[1] for p in self.parts.values())),
            "transcendentals": float(sum(p[2] for p in self.parts.values())),
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(args) -> List[torch.Tensor]:
    """The tensors of an op's arguments, one list level deep (``cat``'s
    inputs, ``index_put``'s indices)."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return []


def _io_bytes(args, kwargs, out) -> int:
    return sum(_nbytes(t) for t in _tensors(args)) + sum(_nbytes(t) for t in _tensors(kwargs.values())) + sum(
        _nbytes(t) for t in _outputs(out))


# ------------------------------------------------------------------ rules
#
# A rule takes (args, kwargs, out) and returns [(source, flops, bytes,
# transcendentals), ...].

def _ops(names: str, in_place: bool = True) -> set:
    """The op packets of these aten names (and of their in-place forms,
    ``add_`` beside ``add``), skipping a name this torch does not have."""
    found = set()
    for name in names.split():
        for n in (name, name + "_") if in_place else (name,):
            try:
                found.add(getattr(aten, n))
            except AttributeError:
                pass
    return found


_FREE = _ops(
    # views and metadata
    "view _unsafe_view _reshape_alias expand permute transpose t slice select as_strided unsqueeze squeeze "
    "detach alias split split_with_sizes unbind narrow diagonal view_as_real view_as_complex unfold lift_fresh "
    "_local_scalar_dense sym_size sym_stride sym_numel sym_storage_offset is_same_size record_stream "
    # allocations
    "empty empty_like empty_strided new_empty new_empty_strided", in_place=False)

_ELEMENTWISE = _ops(
    "add sub rsub mul div neg abs maximum minimum gt lt ge le eq ne logical_and logical_or logical_not "
    "logical_xor bitwise_and bitwise_or bitwise_xor bitwise_not bitwise_left_shift bitwise_right_shift "
    "__lshift__ __rshift__ __and__ __or__ remainder fmod floor_divide round floor ceil trunc sign reciprocal "
    "where masked_fill clamp_min clamp_max relu isnan isinf isfinite nan_to_num square copysign signbit")

_TRANSCENDENTAL = _ops(
    "exp exp2 expm1 log log2 log10 log1p tanh rsqrt sqrt erf erfc erfinv sin cos tan asin acos atan atan2 "
    "sinh cosh asinh acosh atanh")

# (flops, transcendentals) an element of XLA's expansion of the jax.nn form
_ACTIVATIONS = {"sigmoid": (3, 1), "silu": (4, 1), "gelu": (4, 1)}

_REDUCTIONS = _ops("sum amax amin max min prod any all argmax argmin", in_place=False)

_GATHERS = _ops("index index_select gather take", in_place=False)

# indexed writes: the positions of the index operand and of the values
_INDEXED_WRITES = {"index_put": (1, 2), "_index_put_impl": (1, 2), "index_copy": (2, 3), "scatter": (2, 3),
                   "index_add": (2, 3), "scatter_add": (2, 3), "scatter_reduce": (2, 3)}
_ACCUMULATING = ("index_add", "scatter_add", "scatter_reduce")

_FILLS = _ops(
    "fill zero zeros ones full zeros_like ones_like full_like new_zeros new_ones new_full arange "
    "scalar_tensor linspace eye")

_COPIES = _ops(
    "_to_copy clone _copy_from _copy_from_and_resize cat stack constant_pad_nd flip roll repeat tril triu",
    in_place=False)


def _numel(out) -> int:
    outs = _outputs(out)
    return outs[0].numel() if outs else 0


def _dot(m: int, n: int, k: int, batch: int = 1) -> int:
    return 2 * batch * m * n * k


def _rule_mm(args, kwargs, out):
    a, b = args[0], args[1]
    return [("dot", _dot(a.shape[0], b.shape[1], a.shape[1]), _io_bytes(args, kwargs, out), 0)]


def _rule_bmm(args, kwargs, out):
    a, b = args[0], args[1]
    return [("dot", _dot(a.shape[1], b.shape[2], a.shape[2], a.shape[0]), _io_bytes(args, kwargs, out), 0)]


def _rule_addmm(args, kwargs, out):
    a, b = args[1], args[2]
    return [("dot", _dot(a.shape[0], b.shape[1], a.shape[1]), _io_bytes(args, kwargs, out), 0),
            ("aten", out.numel(), 0, 0)]  # the bias added to each output element


def _rule_baddbmm(args, kwargs, out):
    a, b = args[1], args[2]
    return [("dot", _dot(a.shape[1], b.shape[2], a.shape[2], a.shape[0]), _io_bytes(args, kwargs, out), 0),
            ("aten", out.numel(), 0, 0)]


def _rule_mv(args, kwargs, out):
    a = args[0]
    return [("dot", _dot(a.shape[0], 1, a.shape[1]), _io_bytes(args, kwargs, out), 0)]


def _rule_dot(args, kwargs, out):
    return [("dot", _dot(1, 1, args[0].numel()), _io_bytes(args, kwargs, out), 0)]


def _rule_pow(args, kwargs, out):
    exponent = args[1] if len(args) > 1 else kwargs.get("exponent")
    n = _numel(out)
    if isinstance(exponent, (int, float)) and float(exponent).is_integer():
        return [("aten", n, _io_bytes(args, kwargs, out), 0)]  # XLA multiplies out an integer power
    return [("aten", 0, _io_bytes(args, kwargs, out), n)]


def _rule_clamp(args, kwargs, out):
    bounds = sum(1 for b in list(args[1:3]) + [kwargs.get("min"), kwargs.get("max")] if b is not None)
    return [("aten", max(bounds, 1) * _numel(out), _io_bytes(args, kwargs, out), 0)]


def _rule_mean(args, kwargs, out):
    # the sum's (input - output) elements, then a divide per output element
    return [("aten", args[0].numel(), _io_bytes(args, kwargs, out), 0)]


def _rows(x: torch.Tensor, dim: int) -> int:
    return x.numel() // max(x.shape[dim], 1) if x.dim() else 1


def _rule_softmax(args, kwargs, out):
    # max, subtract, exp, sum, divide
    n, rows = args[0].numel(), _rows(args[0], args[1])
    return [("aten", 4 * n - 2 * rows, _io_bytes(args, kwargs, out), n)]


def _rule_log_softmax(args, kwargs, out):
    # max, subtract, exp, sum, log, subtract
    n, rows = args[0].numel(), _rows(args[0], args[1])
    return [("aten", 3 * n - 2 * rows, _io_bytes(args, kwargs, out), n + rows)]


def _rule_gather(args, kwargs, out):
    # the indices, and as many bytes of the source as are written
    idx = sum(_nbytes(t) for t in _tensors(args[1:]) + _tensors(kwargs.values()))
    return [("aten", 0, idx + 2 * sum(_nbytes(t) for t in _outputs(out)), 0)]


def _rule_embedding(args, kwargs, out):
    # embedding(weight, indices): the rows of weight it gathers
    return [("aten", 0, _nbytes(args[1]) + 2 * _nbytes(out), 0)]


def _written_elements(put: bool, args, values) -> int:
    """Elements an indexed write stores: its values', or where the values
    broadcast (a scalar into index_put's indexed rows), the indexed region's."""
    if isinstance(values, torch.Tensor) and values.numel() > 1:
        return values.numel()
    if put:
        dst, indices = args[0], [t for t in args[1] if t is not None]
        shape = torch.broadcast_shapes(*[t.shape for t in indices]) if indices else ()
        return math.prod(shape) * math.prod(dst.shape[len(args[1]):])
    return args[2].numel()


def _indexed_write_rule(name):
    where_index, where_values = _INDEXED_WRITES[name]
    put, accumulating = name in ("index_put", "_index_put_impl"), name in _ACCUMULATING

    def rule(args, kwargs, out):
        dst, index = args[0], args[where_index]
        values = args[where_values] if len(args) > where_values else kwargs.get("source", kwargs.get("src"))
        n = _written_elements(put, args, values)
        nbytes = sum(_nbytes(t) for t in _tensors([index])) + n * dst.element_size()
        if isinstance(values, torch.Tensor):
            nbytes += _nbytes(values)
        accumulate = accumulating or (put and len(args) > 3 and bool(args[3])) or bool(kwargs.get("accumulate"))
        return [("aten", n if accumulate else 0, nbytes, 0)]

    return rule


def _rule_copy_(args, kwargs, out):
    # copy_(dst, src): src read, dst (a view, often) written
    dst, src = args[0], args[1]
    return [("aten", dst.numel() if dst.dtype != src.dtype else 0, _nbytes(src) + _nbytes(dst), 0)]


def _rule_copy(args, kwargs, out):
    src, outs = args[0], _outputs(out)
    cast = outs and isinstance(src, torch.Tensor) and outs[0].dtype != src.dtype
    return [("aten", outs[0].numel() if cast else 0, _io_bytes(args, kwargs, out), 0)]


def _rule_fill(args, kwargs, out):
    return [("aten", 0, sum(_nbytes(t) for t in _outputs(out)), 0)]


def _rule_elementwise(args, kwargs, out):
    return [("aten", _numel(out), _io_bytes(args, kwargs, out), 0)]


def _rule_transcendental(args, kwargs, out):
    return [("aten", 0, _io_bytes(args, kwargs, out), _numel(out))]


def _activation_rule(flops, trans):
    def rule(args, kwargs, out):
        n = _numel(out)
        return [("aten", flops * n, _io_bytes(args, kwargs, out), trans * n)]

    return rule


def _rule_reduction(args, kwargs, out):
    outs = _outputs(out)
    return [("aten", args[0].numel() - (outs[0].numel() if outs else 1), _io_bytes(args, kwargs, out), 0)]


def _rule_fallback(args, kwargs, out):
    return [("aten", 0, _io_bytes(args, kwargs, out), 0)]


_RULES = {}
for _op in _ELEMENTWISE:
    _RULES[_op] = _rule_elementwise
for _op in _TRANSCENDENTAL:
    _RULES[_op] = _rule_transcendental
for _name, (_f, _t) in _ACTIVATIONS.items():
    for _op in _ops(_name):
        _RULES[_op] = _activation_rule(_f, _t)
for _op in _REDUCTIONS:
    _RULES[_op] = _rule_reduction
for _op in _GATHERS:
    _RULES[_op] = _rule_gather
for _name in _INDEXED_WRITES:
    for _op in _ops(_name):
        _RULES[_op] = _indexed_write_rule(_name)
for _op in _FILLS:
    _RULES[_op] = _rule_fill
for _op in _COPIES:
    _RULES[_op] = _rule_copy
for _names, _rule in (("mm", _rule_mm), ("bmm", _rule_bmm), ("addmm", _rule_addmm), ("baddbmm", _rule_baddbmm),
                      ("mv", _rule_mv), ("dot", _rule_dot), ("pow", _rule_pow), ("clamp", _rule_clamp),
                      ("mean", _rule_mean), ("_softmax", _rule_softmax), ("_log_softmax", _rule_log_softmax),
                      ("embedding", _rule_embedding)):
    for _op in _ops(_names):
        _RULES[_op] = _rule
_RULES[aten.copy_] = _rule_copy_
_RULES[aten.copy] = _rule_copy


class OpCounter(TorchDispatchMode):
    """Counts each aten op this thread runs into ``cost`` by the rules
    above, from shapes and dtypes alone, and runs the op unchanged."""

    @classmethod
    def _should_skip_dynamo(cls):
        # keep __torch_dispatch__ unwrapped: nothing here runs under
        # torch.compile, and the wrapper's frame guard costs every op
        return False

    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _FREE:
            return out
        rule = _RULES.get(packet)
        if rule is None:
            self.cost.unlisted.add(str(packet))
            rule = _rule_fallback
        for source, flops, nbytes, trans in rule(args, kwargs, out):
            self.cost.add(source, flops, nbytes, trans)
        return out


__all__ = ["OpCounter", "StepCost"]
