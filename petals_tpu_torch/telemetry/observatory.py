"""Step-program observatory: the port's counterpart of
petals_tpu/telemetry/observatory.py's ``tracked_jit``.

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
  run ``DEFAULT_WARMUP_CALLS`` calls that captured nothing, a capture is an
  anomaly (a bucketing bug, a drifting shape). A non-steady program's keys
  come and go with the caches they write (a private session's steps, its
  generation step, the stateless forward): the first call of a key runs
  the function eagerly on the capture stream (its warm-up, counted in
  ``eager_calls``), the second captures and replays it, later calls replay;
  so a key that runs once, as most prefill chunks do, never pays a capture,
  and its captures are never anomalies. ``drop`` forgets the keys whose
  graphs write a freed cache: a graph never outlives the memory it writes
  by address. Per program name the observatory counts calls, eager calls,
  captures, replays and capture seconds.
- ``compile_stats()`` is the JAX package's digest with the fields a capture
  can fill: ``functions``, ``programs`` (captures), ``compile_s`` (capture
  seconds) and ``anomalies``, plus ``replays``.
- ``count_launch``: the kernel wrappers (ops/) count their launches on the
  host, and a replay calls no wrapper. A launch counted while this thread
  captures belongs to that graph instead of the host counter, and each
  replay of the graph adds it again, so a counter reads the same whether a
  step ran eagerly or replayed.

Not ported: the journal, the flight recorder, per-program cost analysis and
the metrics exposition (they wait for the rest of the telemetry package).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Hashable, List, NamedTuple, Optional, Sequence, Tuple

import torch

DEFAULT_WARMUP_CALLS = 8

_TLS = threading.local()  # .record: the launch record of the capture running on this thread
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
    """Registry of the step programs' counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: List[ProgramCounts] = []

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


_OBSERVATORY: Optional[Observatory] = None
_OBSERVATORY_LOCK = threading.Lock()


def get_observatory() -> Observatory:
    global _OBSERVATORY
    with _OBSERVATORY_LOCK:
        if _OBSERVATORY is None:
            _OBSERVATORY = Observatory()
        return _OBSERVATORY


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

    Once a steady instance has run ``DEFAULT_WARMUP_CALLS`` calls that
    replayed a graph it already held, a capture is an anomaly. Warm-up and
    anomalies are per instance, as ``tracked_jit``'s are: a fresh backend
    captures its own graphs. ``capture`` is the capture backend
    (``CudaGraphCapture`` on a card; a test may hand in a stand-in with the
    same ``device``, ``warm`` and ``capture``)."""

    def __init__(self, name: str, capture, *, steady: bool = True, observatory: Optional[Observatory] = None):
        self._capture = capture
        self.steady = steady
        self.counts = (observatory if observatory is not None else get_observatory()).register(name)
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
            entry = self._entries[key] = self._capture_entry(fn, inputs)
        else:
            for buf, x in zip(entry.inputs, inputs):
                buf.copy_(x)
        entry.graph.replay()
        for owner, attr, k in entry.launches:
            _bump(owner, attr, k)
        self.counts.calls += 1
        self.counts.replays += 1
        return tuple(out.clone() for out in entry.outputs)

    def _capture_entry(self, fn: Callable, inputs: Sequence[torch.Tensor]) -> _Entry:
        # warm-up is counted in calls that replayed a graph already held: a
        # pool's warm-up, which captures every bucket in a row, is never an
        # anomaly however many buckets it has
        replayed = self.counts.calls - self.counts.captures - self.counts.eager_calls
        anomaly = self.steady and replayed >= DEFAULT_WARMUP_CALLS
        device = self._capture.device
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs)
        for buf, x in zip(static, inputs):
            buf.copy_(x)
        with _CAPTURE_LOCK:
            if self.steady:  # a non-steady key's eager call was its warm-up
                self._capture.warm(fn, static)
            record: List[tuple] = []
            t0 = time.perf_counter()
            _TLS.record = record
            try:
                graph, outputs = self._capture.capture(fn, static)
            finally:
                _TLS.record = None
            seconds = time.perf_counter() - t0
        self.counts.captures += 1
        self.counts.capture_s += seconds
        self.counts.anomalies += int(anomaly)
        return _Entry(graph, static, tuple(outputs), tuple(record))
