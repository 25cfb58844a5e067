"""Step-program observatory: the port's counterpart of
petals_tpu/telemetry/observatory.py's ``tracked_jit`` and its cost table.

The JAX package runs each served step as one compiled XLA program per
shape, and its observatory counts compiles: after a ``steady`` function's
warm-up calls, a compile is an anomaly (a bucketing bug, a drifting shape).
The port runs each served step on the card as a CUDA graph, captured once
per key and replayed (server/backend.py), so here the capture takes the
compile's place:

- ``TrackedGraph`` runs a step function as one graph per key, and is
  ``steady`` or not, as ``tracked_jit`` is. A steady program's keys are all
  captured when a pool opens (the paged and dense pools' steps): the first
  call of a key copies its inputs into static buffers, warms the function
  up on the capture stream and captures it; every call replays. Once it has
  run ``warmup_calls`` calls that captured nothing (the observatory's:
  ``PETALS_TPU_COMPILE_WARMUP``, else ``DEFAULT_WARMUP_CALLS``), a capture is
  an anomaly (a bucketing bug, a drifting shape). A non-steady program's keys
  come and go with the caches they write (a private session's steps, its
  generation step, the stateless forward): the first call of a key runs
  the function eagerly on the capture stream (its warm-up, counted in
  ``eager_calls``), the second captures and replays it, later calls replay;
  so a key that runs once, as most prefill chunks do, never pays a capture,
  and its captures are never anomalies. ``drop`` forgets the keys whose
  graphs write a freed cache: a graph never outlives the memory it writes
  by address. Per program name the observatory counts calls, eager calls,
  captures, replays and capture seconds.
- Every capture adds a ``ProgramRecord`` (the JAX package's fields: the
  program's name, key, static inputs as avals, their bytes, the capture's
  seconds, whether it was an anomaly), kept in order up to ``max_programs``
  (``dropped_programs`` counts the rest), and writes the journal's
  ``compile`` event; an anomaly also writes ``compile_anomaly`` and a
  flight-recorder ``recompile`` entry whose evidence is the journal's
  compile tail.
- The cost of a step program, the counterpart of XLA's ``cost_analysis()``:
  the capture's own run of the function counts its work
  (telemetry/op_cost.py: every aten op by dispatch, each kernel launch by
  its wrapper's formula, ``count_cost``), once, at capture; nothing runs for
  it. A block whose signature (``_signature``: its arguments' shapes,
  strides, dtypes, devices and plain values) was counted before, in this
  capture or an earlier one, runs uncounted and adds that count
  (``counted_once``, which the backend's block loops call): a dispatch mode
  costs some 13 us an op, so counting every op would double a capture's
  seconds. ``analyze`` / ``cost_table`` serve it as the JAX package serves XLA's,
  and ``roofline`` divides a program's flops by a measured step time.
  ``memory=True`` adds what the capture measured: the bytes the graph pool
  grew by, less the outputs (``temp_bytes``, null without a card; graphs of
  one backend share one pool, so a graph that fits in what earlier ones
  freed adds none), the static inputs' and outputs' bytes, and
  ``code_bytes`` 0: a graph has no code image of its own.
- ``compile_stats()`` is the JAX package's digest with the fields a capture
  can fill: ``functions``, ``programs`` (captures), ``compile_s`` (capture
  seconds) and ``anomalies``, plus ``replays``.
- ``count_launch``: the kernel wrappers (ops/) count their launches on the
  host, and a replay calls no wrapper. A launch counted while this thread
  captures belongs to that graph instead of the host counter, and each
  replay of the graph adds it again, so a counter reads the same whether a
  step ran eagerly or replayed.
- Each capture also counts into the registry's ``petals_compiles_total``,
  ``petals_compile_seconds_total`` and ``petals_compile_anomalies_total``
  by program name, ``analyze`` sets ``petals_compiled_program_flops`` and
  ``petals_compiled_program_bytes_accessed`` (telemetry/instruments.py), and
  ``/compile`` (telemetry/exposition.py) serves the view the JAX package's
  does.

A span over a mesh (tensor or sequence parallel, or across processes) steps
eagerly and captures nothing (server/backend.py), so its server has no
program records and no costs, as it has no capture counters.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import os
import threading
import time
from typing import Callable, Dict, Hashable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode, _pop_mode_temporarily

from petals_tpu_torch.telemetry.journal import get_journal
from petals_tpu_torch.telemetry.op_cost import OpCounter, StepCost

DEFAULT_WARMUP_CALLS = 8
MAX_PROGRAM_RECORDS = 512
_AVALS_CAP = 24  # journal events carry at most this many per-input avals

# .record: the launch record of the capture running on this thread;
# .cost: the StepCost this thread counts into (a capture's, or ``counting``'s),
# .counter: the OpCounter counting it
_TLS = threading.local()
_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process (servers may share it)


def count_launch(owner, attr: str, key: Optional[Hashable] = None) -> None:
    """Count one kernel launch in ``owner.<attr>`` (an int), or in
    ``owner.<attr>[key]`` (a dict of ints). While this thread captures a
    graph the launch is recorded for that graph, whose replays count it."""
    record = getattr(_TLS, "record", None)
    if record is not None:
        record.append((owner, attr, key))
    else:
        _bump(owner, attr, key)


def _bump(owner, attr: str, key: Optional[Hashable]) -> None:
    # looked up at each count: a reset replaces the counter objects
    if key is None:
        setattr(owner, attr, getattr(owner, attr) + 1)
    else:
        getattr(owner, attr)[key] += 1


def count_cost(source: str, cost_fn: Callable, *args) -> None:
    """A kernel wrapper's report of one launch's work: ``cost_fn(*args)``,
    its (flops, bytes, transcendentals), counted under ``source`` while this
    thread counts costs (a capture, or a ``counting`` block); otherwise
    nothing is computed."""
    cost = getattr(_TLS, "cost", None)
    if cost is not None:
        cost.add(source, *cost_fn(*args))


@contextlib.contextmanager
def counting(cost: Optional[StepCost] = None):
    """Count the work this thread does in the block into ``cost`` (a new
    ``StepCost`` if None), which it yields: every aten op by dispatch
    (``OpCounter``), every kernel launch by its wrapper's ``count_cost``."""
    cost = StepCost() if cost is None else cost
    outer = getattr(_TLS, "cost", None), getattr(_TLS, "counter", None)
    counter = OpCounter(cost)
    _TLS.cost, _TLS.counter = cost, counter
    try:
        with counter:
            yield cost
    finally:
        _TLS.cost, _TLS.counter = outer


class _Unmemoizable(Exception):
    """An argument whose effect on a call's work its signature cannot tell."""


def _signature(x):
    """A call's arguments by everything its work can depend on: a tensor by
    its shape, strides, dtype and device (a small host tensor by its values
    too: a block may read one), containers, named tuples and dataclasses
    (configs, quantized weights) by their items, a plain value as it is.
    Anything else raises ``_Unmemoizable``."""
    if isinstance(x, torch.Tensor):
        sig = (x.shape, x.stride(), x.dtype, x.device)
        if x.device.type == "cpu" and x.numel() <= 64:
            sig += (tuple(x.reshape(-1).tolist()),)
        return sig
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device)):
        return x
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _signature(v)) for k, v in x.items())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x),) + tuple(_signature(getattr(x, f.name)) for f in dataclasses.fields(x))
    raise _Unmemoizable(type(x))


_BLOCK_COSTS: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
_BLOCK_COSTS_MAX = 1024  # distinct block signatures kept, the least recently used dropped first
_BLOCK_COSTS_LOCK = threading.Lock()


def clear_block_costs() -> int:
    """Forget every block's counted cost (so the next captures count their
    blocks op by op again, as a fresh process does); returns how many."""
    with _BLOCK_COSTS_LOCK:
        n = len(_BLOCK_COSTS)
        _BLOCK_COSTS.clear()
    return n


def counted_once(fn: Callable) -> Callable:
    """``fn`` (a block's apply), counted op by op once for each signature of
    its arguments (``_signature``) in the process: a span's blocks repeat
    one block's work at the same shapes, and a pool's programs repeat it
    (a decode step's blocks are a mixed step's decode half), so a call
    whose signature was counted before runs uncounted (no dispatch mode on
    the stack, kernel reports off) and adds that count. Outside a count it
    is ``fn``."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        cost, counter = getattr(_TLS, "cost", None), getattr(_TLS, "counter", None)
        if cost is None or counter is None:
            return fn(*args, **kwargs)
        try:
            sig = (fn, _signature(args), _signature(kwargs))
        except _Unmemoizable:
            return fn(*args, **kwargs)
        with _BLOCK_COSTS_LOCK:
            known = _BLOCK_COSTS.get(sig)
            if known is not None:
                _BLOCK_COSTS.move_to_end(sig)
        if known is None or _get_current_dispatch_mode() is not counter:  # count it op by op
            before = cost.snapshot()
            out = fn(*args, **kwargs)
            with _BLOCK_COSTS_LOCK:
                _BLOCK_COSTS[sig] = cost.since(before)
                while len(_BLOCK_COSTS) > _BLOCK_COSTS_MAX:
                    _BLOCK_COSTS.popitem(last=False)
            return out
        _TLS.cost = None
        try:
            with _pop_mode_temporarily():
                out = fn(*args, **kwargs)
        finally:
            _TLS.cost = cost
        cost.merge(known)
        return out

    return call


def _aval(t: torch.Tensor) -> str:
    """A static input as the JAX package writes an aval: "bfloat16[4,1,4096]"."""
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(map(str, t.shape))}]"


def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ProgramRecord:
    """One captured graph of one tracked program (the JAX package's record
    of a compiled executable, its fields by their names there)."""

    __slots__ = ("fn", "steady", "key", "avals", "n_leaves", "arg_bytes", "compile_s", "t", "anomaly", "cost",
                 "memory", "counted", "_memory")

    def __init__(self, fn, steady, key, avals, n_leaves, arg_bytes, compile_s, anomaly, counted, memory):
        self.fn = fn
        self.steady = steady
        self.key = key
        self.avals = avals
        self.n_leaves = n_leaves
        self.arg_bytes = arg_bytes
        self.compile_s = compile_s
        self.t = time.time()  # wall timestamp for operators, not a span
        self.anomaly = anomaly
        self.cost: Optional[dict] = None
        self.memory: Optional[dict] = None
        self.counted: Optional[StepCost] = counted  # by source; None when the capture counted nothing
        self._memory = memory  # measured at capture; attached by analyze(memory=True)

    def as_dict(self) -> dict:
        out = {
            "fn": self.fn,
            "steady": self.steady,
            "key": self.key,
            "avals": self.avals,
            "n_leaves": self.n_leaves,
            "arg_bytes": self.arg_bytes,
            "compile_s": round(self.compile_s, 4),
            "t": self.t,
            "anomaly": self.anomaly,
        }
        if self.cost is not None:
            out["cost"] = self.cost
        if self.memory is not None:
            out["memory"] = self.memory
        return out


class ProgramCounts:
    """One ``TrackedGraph``'s counters. The observatory keeps these, never
    the graphs, so a backend that is dropped frees its graphs and leaves its
    counts behind."""

    __slots__ = ("name", "calls", "eager_calls", "captures", "replays", "capture_s", "anomalies")

    def __init__(self, name: str):
        self.name = name
        self.calls = self.eager_calls = self.captures = self.replays = self.anomalies = 0
        self.capture_s = 0.0


class Observatory:
    """Registry of the step programs' counters and captured programs.

    ``warmup_calls`` (None: ``PETALS_TPU_COMPILE_WARMUP``, else
    ``DEFAULT_WARMUP_CALLS``) is the steady programs' warm-up; at most
    ``max_programs`` records are kept, the oldest dropped first;
    ``count_costs`` False captures without counting costs (to measure what
    counting adds to a capture)."""

    def __init__(self, *, warmup_calls: Optional[int] = None, max_programs: int = MAX_PROGRAM_RECORDS,
                 count_costs: bool = True):
        if warmup_calls is None:
            try:
                warmup_calls = int(os.environ.get("PETALS_TPU_COMPILE_WARMUP", DEFAULT_WARMUP_CALLS))
            except ValueError:
                warmup_calls = DEFAULT_WARMUP_CALLS
        self.warmup_calls = max(int(warmup_calls), 1)
        self.max_programs = int(max_programs)
        self.count_costs = bool(count_costs)
        self._lock = threading.Lock()
        self._counts: List[ProgramCounts] = []
        self._programs: "collections.OrderedDict[int, ProgramRecord]" = collections.OrderedDict()
        self._program_seq = 0
        self.dropped_programs = 0
        self._flight = None  # FlightRecorder, created on the first anomaly

    # ------------------------------------------------------------- registry

    def register(self, name: str) -> ProgramCounts:
        counts = ProgramCounts(name)
        with self._lock:
            self._counts.append(counts)
        return counts

    def functions(self) -> List[dict]:
        """Per program name, the totals of every graph of that name (each
        backend in a process has a ``paged_decode``, a ``paged_mixed_step``
        and so on)."""
        with self._lock:
            counts = list(self._counts)
        by_name: Dict[str, dict] = {}
        for c in counts:
            f = by_name.setdefault(c.name, {"fn": c.name, "calls": 0, "eager_calls": 0, "captures": 0,
                                            "replays": 0, "capture_s": 0.0, "anomalies": 0})
            for field in ("calls", "eager_calls", "captures", "replays", "capture_s", "anomalies"):
                f[field] += getattr(c, field)
        for f in by_name.values():
            f["capture_s"] = round(f["capture_s"], 4)
        return list(by_name.values())

    def programs(self) -> List[ProgramRecord]:
        with self._lock:
            return list(self._programs.values())

    def compile_stats(self) -> dict:
        """The JAX package's ``compile_stats`` digest, a capture standing for
        a compile."""
        functions = self.functions()
        return {
            "functions": len(functions),
            "programs": sum(f["captures"] for f in functions),
            "compile_s": round(sum(f["capture_s"] for f in functions), 3),
            "anomalies": sum(f["anomalies"] for f in functions),
            "replays": sum(f["replays"] for f in functions),
        }

    # ------------------------------------------------------------- recording

    def _record_capture(self, counts: ProgramCounts, steady: bool, key: Hashable, inputs, outputs, seconds: float,
                        anomaly: bool, counted: Optional[StepCost], temp_bytes: Optional[int]) -> ProgramRecord:
        """A capture's record, metrics, journal events and, for an anomaly,
        flight entry (the JAX package's ``_record_compile``)."""
        from petals_tpu_torch.telemetry import instruments as tm

        avals = [_aval(t) for t in inputs]
        capped = avals if len(avals) <= _AVALS_CAP else avals[:_AVALS_CAP] + [f"... +{len(avals) - _AVALS_CAP} more"]
        arg_bytes = _nbytes(inputs)
        memory = {"temp_bytes": temp_bytes, "argument_bytes": arg_bytes, "output_bytes": _nbytes(outputs),
                  "code_bytes": 0}
        record = ProgramRecord(counts.name, steady, str(key), capped, len(avals), arg_bytes, seconds, anomaly,
                               counted, memory)
        with self._lock:
            self._program_seq += 1
            self._programs[self._program_seq] = record
            while len(self._programs) > self.max_programs:
                self._programs.popitem(last=False)
                self.dropped_programs += 1
            compiles = sum(c.captures for c in self._counts if c.name == counts.name)
        tm.COMPILES.labels(fn=counts.name).inc()
        tm.COMPILE_SECONDS.labels(fn=counts.name).inc(seconds)
        journal = get_journal()
        journal.event("compile", fn=counts.name, key=record.key, avals=capped, compile_s=round(seconds, 4),
                      compiles=compiles, steady=steady)
        if anomaly:
            tm.COMPILE_ANOMALIES.labels(fn=counts.name).inc()
            journal.event("compile_anomaly", fn=counts.name, key=record.key, avals=capped,
                          compile_s=round(seconds, 4), warmup_calls=self.warmup_calls)
            self.flight_recorder().record(
                "recompile", fn=counts.name, avals=capped, compile_s=round(seconds, 4),
                # resolved only when the entry is written: the compile tail
                journal=lambda: get_journal().events(kind="compile")[-8:],
            )
        return record

    # ---------------------------------------------------------- flight hookup

    def attach_flight(self, recorder) -> None:
        self._flight = recorder

    def flight_recorder(self):
        if self._flight is None:
            from petals_tpu_torch.telemetry.flight import FlightRecorder

            with self._lock:
                if self._flight is None:
                    self._flight = FlightRecorder(path=os.environ.get("PETALS_TPU_FLIGHT") or None)
        return self._flight

    # ------------------------------------------------------------- analysis

    def analyze(self, record: ProgramRecord, *, memory: bool = False) -> ProgramRecord:
        """Fill ``record.cost`` from what its capture counted, and with
        ``memory`` ``record.memory`` from what it measured (module
        docstring); sets the program's flops and bytes gauges."""
        if record.cost is None:
            if record.counted is None:
                record.cost = {"error": "the capture counted no cost (Observatory(count_costs=False))"}
            else:
                from petals_tpu_torch.telemetry import instruments as tm

                record.cost = record.counted.total()
                tm.COMPILED_FLOPS.labels(fn=record.fn).set(record.cost["flops"])
                tm.COMPILED_BYTES.labels(fn=record.fn).set(record.cost["bytes_accessed"])
        if memory and record.memory is None:
            record.memory = dict(record._memory)
        return record

    def cost_table(self, *, memory: bool = False, fn: Optional[str] = None) -> List[dict]:
        """Per-program cost table (the ``/compile`` view): the recorded
        programs with their cost attached; ``fn`` narrows it to one program
        name."""
        records = self.programs()
        if fn is not None:
            records = [r for r in records if r.fn == fn]
        return [self.analyze(r, memory=memory).as_dict() for r in records]

    # ------------------------------------------------------------- roofline

    @staticmethod
    def peak_flops() -> Optional[float]:
        """Peak FLOP/s for utilization math, from ``PETALS_TPU_PEAK_TFLOPS``
        (None when unset: there is no honest peak to divide by unless one
        is declared; achieved FLOP/s is still reported, utilization stays
        null)."""
        raw = os.environ.get("PETALS_TPU_PEAK_TFLOPS")
        if not raw:
            return None
        try:
            return float(raw) * 1e12
        except ValueError:
            return None

    def roofline(self, fn: str, step_seconds: float) -> Optional[dict]:
        """Achieved-vs-roofline utilization for one program name: the
        largest recorded program's flops over the measured step time."""
        if step_seconds <= 0:
            return None
        candidates = [r for r in self.programs() if r.fn == fn]
        if not candidates:
            return None
        for r in candidates:
            self.analyze(r)
        flops = max((r.cost or {}).get("flops", 0.0) or 0.0 for r in candidates)
        if flops <= 0:
            return None
        achieved = flops / step_seconds
        peak = self.peak_flops()
        return {
            "fn": fn,
            "flops_per_step": flops,
            "step_mean_ms": round(step_seconds * 1e3, 3),
            "achieved_gflops": round(achieved / 1e9, 3),
            "utilization": (round(achieved / peak, 4) if peak else None),
        }

    def reset(self) -> None:
        """Drop every record and counter (tests). Programs tracked before
        keep counting into counters no longer listed."""
        with self._lock:
            self._counts.clear()
            self._programs.clear()
            self._program_seq = 0
            self.dropped_programs = 0


_OBSERVATORY: Optional[Observatory] = None
_OBSERVATORY_LOCK = threading.Lock()


def get_observatory() -> Observatory:
    global _OBSERVATORY
    with _OBSERVATORY_LOCK:
        if _OBSERVATORY is None:
            _OBSERVATORY = Observatory()
        return _OBSERVATORY


def compile_stats_digest() -> dict:
    return get_observatory().compile_stats()


class CudaGraphCapture:
    """Warm-up and capture for ``TrackedGraph`` on a CUDA device: both on
    one side stream of the device, every graph into one memory pool
    (``torch.cuda.graph_pool_handle()``), so that the graphs of one backend,
    which never run at once, share their scratch. The stream and pool are
    made on first use. The warm-up run does the one-time host work a capture
    refuses (the kernels' build and load, their shared-memory attributes,
    device-property queries, constant uploads, the split merge's counters of
    this stream) and runs the step once for real; it returns the step's
    outputs (a non-steady key's first call is its warm-up)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def warm(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        stream, current = self._side_stream(), torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            outputs = fn(*inputs)
        current.wait_stream(stream)
        for out in outputs:
            out.record_stream(current)  # the caller reads them on its own stream
        return outputs

    def capture(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        """(graph, outputs): one call of ``fn(*inputs)`` captured; raises
        if the capture fails (nothing falls back to running eagerly)."""
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (another server's steps, a client in
        # the same process) keep working while this one captures
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream(), capture_error_mode="thread_local"):
            outputs = fn(*inputs)
        return graph, outputs


class _Entry(NamedTuple):
    graph: object  # has replay()
    inputs: Tuple[torch.Tensor, ...]  # the static input buffers
    outputs: Tuple[torch.Tensor, ...]  # the static outputs
    launches: Tuple[tuple, ...]  # (owner, attr, key) of each launch the capture counted


class TrackedGraph:
    """A step function replayed as graphs, one per key, with its captures
    observed (the counterpart of ``tracked_jit``, ``steady`` as there).

    ``run(key, fn, inputs)``: ``fn(*static_inputs)`` returns a tuple of
    tensors. The call that captures a key allocates static buffers like
    ``inputs`` on the capture's device and copies the inputs in, captures
    ``fn`` and replays it; later calls of the key copy the inputs into its
    buffers and replay. A steady program captures on a key's first call,
    after a warm-up run of ``fn``; a non-steady one runs a key's first call
    eagerly through the capture's ``warm`` (which returns the outputs: the
    same run, once) and captures on its second, with no further warm-up, so
    a function with effects that do not repeat (a beam reorder of a cache)
    runs exactly once a call. Everything else ``fn`` reads (weights, page
    pools, caches) is baked into the graph by address, so the key must tell
    apart everything that differs there. Returns clones of the static
    outputs: a result stays valid after the next replay.

    Once a steady instance has run its observatory's ``warmup_calls``
    calls that replayed a graph it already held, a capture is an anomaly.
    Warm-up and anomalies are per instance, as ``tracked_jit``'s are: a
    fresh backend captures its own graphs. ``capture`` is the capture
    backend (``CudaGraphCapture`` on a card; a test may hand in a stand-in
    with the same ``device``, ``warm`` and ``capture``). Each capture is
    recorded in the observatory (``ProgramRecord``), its cost counted while
    the capture runs ``fn`` (unless the observatory counts no costs)."""

    def __init__(self, name: str, capture, *, steady: bool = True, observatory: Optional[Observatory] = None):
        self._capture = capture
        self.steady = steady
        self._observatory = observatory if observatory is not None else get_observatory()
        self.counts = self._observatory.register(name)
        self._entries: Dict[Hashable, _Entry] = {}
        self._seen: set = set()  # a non-steady program's keys that ran their eager call

    def drop(self, predicate: Callable[[Hashable], bool]) -> int:
        """Forget every key ``predicate`` selects, its graph and its eager
        call; returns how many graphs went. For a cache about to be freed."""
        for key in [k for k in list(self._seen) if predicate(k)]:
            self._seen.discard(key)
        dropped = [k for k in list(self._entries) if predicate(k)]
        for key in dropped:
            self._entries.pop(key, None)
        return len(dropped)

    def run(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        entry = self._entries.get(key)
        if entry is None and not self.steady and key not in self._seen:
            outputs = tuple(self._capture.warm(fn, inputs))
            self._seen.add(key)
            self.counts.calls += 1
            self.counts.eager_calls += 1
            return outputs
        if entry is None:
            entry = self._entries[key] = self._capture_entry(key, fn, inputs)
        else:
            for buf, x in zip(entry.inputs, inputs):
                buf.copy_(x)
        entry.graph.replay()
        for owner, attr, k in entry.launches:
            _bump(owner, attr, k)
        self.counts.calls += 1
        self.counts.replays += 1
        return tuple(out.clone() for out in entry.outputs)

    def _capture_entry(self, key: Hashable, fn: Callable, inputs: Sequence[torch.Tensor]) -> _Entry:
        obs = self._observatory
        # warm-up is counted in calls that replayed a graph already held: a
        # pool's warm-up, which captures every bucket in a row, is never an
        # anomaly however many buckets it has
        replayed = self.counts.calls - self.counts.captures - self.counts.eager_calls
        anomaly = self.steady and replayed >= obs.warmup_calls
        device = self._capture.device
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs)
        for buf, x in zip(static, inputs):
            buf.copy_(x)
        cost = StepCost() if obs.count_costs else None
        on_card = torch.device(device).type == "cuda"
        with _CAPTURE_LOCK:
            if self.steady:  # a non-steady key's eager call was its warm-up
                self._capture.warm(fn, static)
            if on_card:  # the capture empties the cache too: the pool's growth is the graph's
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(device)
            record: List[tuple] = []
            t0 = time.perf_counter()
            _TLS.record = record
            try:
                graph, outputs = self._capture.capture(fn if cost is None else _count_first_call(fn, cost), static)
            finally:
                _TLS.record = None
            seconds = time.perf_counter() - t0
            grown = torch.cuda.memory_reserved(device) - reserved if on_card else None
        outputs = tuple(outputs)
        self.counts.captures += 1
        self.counts.capture_s += seconds
        self.counts.anomalies += int(anomaly)
        temp = None if grown is None else max(0, grown - _nbytes(outputs))
        obs._record_capture(self.counts, self.steady, key, static, outputs, seconds, anomaly, cost, temp)
        return _Entry(graph, static, outputs, tuple(record))


def _count_first_call(fn: Callable, cost: StepCost) -> Callable:
    """``fn``, its first call counted into ``cost`` (a stand-in capture's
    replay calls it again, uncounted, as a graph's replay counts nothing)."""
    state = {"counted": False}

    def run(*inputs):
        if state["counted"]:
            return fn(*inputs)
        state["counted"] = True
        with counting(cost):
            return fn(*inputs)

    return run
