"""Multi-host serving: one span server over several processes' devices (the
port of petals_tpu/parallel/multihost.py).

Where the JAX package runs multi-controller SPMD over a global mesh, the
port runs one ``torch.distributed`` process group:

- ``init_multihost`` joins it (``tcp://<coordinator_address>``, an explicit
  timeout) and learns every process's devices. Process 0 is the LEADER: it
  runs the swarm surface (DHT, RPC handler, scheduler, memory budget).
  Processes 1..n-1 are WORKERS (cli/run_worker.py): each builds the
  identical backend from the identical checkpoint and sits in
  ``LockstepWorker.run``.
- ``multihost_layout`` lays the global tp x sp grid over the processes'
  devices in ``parallel/mesh.py serving_devices``' order (entry ``t * sp +
  s``: tp shard t of sp rank s), each process holding the entries of the
  devices it owns, and builds the data groups the blocks' collectives run
  on (parallel/collectives.py ``GroupLayout``): NCCL where every process
  has a card of its own, gloo otherwise (two processes on one card).
- Every leader-side compute call broadcasts a compact header (and its
  operands) on a gloo group on the CPU, separate from the data group, and
  the workers invoke the same backend method on their shards; the
  collectives inside the blocks then pair up across processes.
- KV buffers are mirrored by HANDLE: the leader's MemoryCache reserves
  handles and budget as usual but broadcasts ALLOC/FREE
  (``LockstepMemoryCache``), and each process allocates its own shards of
  the same logical buffer. The leader finds an allocation's handle from
  the buffer itself (``_MIRRORS``, MemoryCache allocations only), so the
  handler and batcher pass their caches as they do on one process.
- The lane pool is one more mirrored allocation; its decode step
  broadcasts hidden and positions (OP_BATCHED_DECODE), and work the
  batched step does not cover checks a lane out under a synthetic negative
  handle minted by the batcher (OP_LANE_EXTRACT: on every process a view
  of its pool's lane, as a dense lane is written in place on one process)
  and back in (OP_LANE_INSERT). The leader's view is a ``LaneCheckout``,
  which carries that handle: a one-lane pool's lane has the pool's own
  address and shape, so the view cannot be told from the pool by them.
- KV export gathers every process's head shards to the leader
  (OP_EXPORT_KV), import broadcasts the prefix and every process writes
  its own heads (OP_IMPORT_KV, the backend's ``seed_cache``).
- A live span move is OP_RELOAD_SPAN: leader and workers rebuild from the
  checkpoint under the broadcast lock.
- A failed op marks the group degraded (``_degrade_on_failure``): every
  later op fails fast with ``MultihostDegraded`` instead of waiting on a
  dead member, and the server re-forms single-host (server/server.py).
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import logging
import os
import socket
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from petals_tpu_torch.parallel.collectives import GroupLayout

logger = logging.getLogger(__name__)

OP_SHUTDOWN = 0
OP_ALLOC = 1
OP_FREE = 2
OP_INFERENCE_STEP = 3
OP_FORWARD = 4
OP_BACKWARD = 5
OP_EXPORT_KV = 6  # every process's head shards of a session's KV, gathered to the leader
OP_IMPORT_KV = 7  # seed a KV mirror from an exported prefix
# continuous batching: the lane pool is one more mirrored allocation, and its
# device ops broadcast like any other. Checked-out lanes live on the workers
# under SYNTHETIC negative handles minted by the leader's DecodeBatcher, so
# exclusive ops (chunked prefill, kv import) target them like session KV.
OP_BATCHED_DECODE = 8
OP_LANE_EXTRACT = 9
OP_LANE_INSERT = 10
# a live span move: every process rebuilds its backend from the checkpoint
# while the leader holds the broadcast lock
OP_RELOAD_SPAN = 11

_HEADER_LEN = 14
_FLAG_PROMPTS = 1
_FLAG_HYPO = 2

# One lockstep op (header + operand broadcasts + the compute and its
# collectives) must reach the group whole: ALLOC/FREE run on the asyncio
# event-loop thread while compute ops run on the PriorityTaskQueue thread —
# interleaved broadcasts would pair a worker's operand wait with the wrong
# leader collective and hang the group. (Workers are single-threaded; only
# the leader needs the lock.)
_BCAST_LOCK = threading.RLock()

# one lockstep group per process, so its health is module state: once a
# collective has failed the members' state is unknown, and every later op
# must fail FAST with a clear error instead of waiting on a fresh collective
_GROUP_STATE = {"degraded": None}

# the group this process joined (init_multihost)
_STATE: Dict[str, object] = {}

# (data_ptr, shape) of a leader's MemoryCache allocation -> its handle on the
# workers (a lane check-out carries its own: LaneCheckout)
_MIRRORS: Dict[Tuple[int, tuple], int] = {}

DEFAULT_TIMEOUT = 60.0  # seconds a collective of the group may wait


class MultihostDegraded(RuntimeError):
    """The lockstep group lost a member; the span server must stop serving."""


def group_degraded() -> Optional[BaseException]:
    """The exception that degraded this process's lockstep group, if any."""
    return _GROUP_STATE["degraded"]


def _check_group() -> None:
    if _GROUP_STATE["degraded"] is not None:
        raise MultihostDegraded(
            f"multihost group degraded: {_GROUP_STATE['degraded']!r} — "
            f"restart the leader and workers to re-form the group"
        ) from _GROUP_STATE["degraded"]


@contextlib.contextmanager
def _degrade_on_failure():
    """Mark the group degraded when a lockstep op dies in a collective."""
    _check_group()
    try:
        yield
    except MultihostDegraded:
        raise
    except Exception as e:
        _GROUP_STATE["degraded"] = e
        logger.error(f"multihost lockstep op failed ({e!r}): marking the group degraded")
        raise MultihostDegraded(
            f"multihost group degraded: {e!r} — restart the leader and workers to re-form the group"
        ) from e


def group_timeout() -> float:
    """Seconds a leader's collective waits for the others: DEFAULT_TIMEOUT.
    ``PETALS_TPU_MULTIHOST_TIMEOUT`` overrides it; it is a test hook (the CPU
    tests bound a dead member's wait more tightly), not a setting to tune."""
    return float(os.environ.get("PETALS_TPU_MULTIHOST_TIMEOUT", DEFAULT_TIMEOUT))


def _device_key(d: torch.device) -> str:
    """Names one physical device across processes: the host and, for a
    card, its UUID (two processes may name one card differently)."""
    if d.type != "cuda":
        return f"{socket.gethostname()}/{d}"
    props = torch.cuda.get_device_properties(d)
    return f"{socket.gethostname()}/cuda/{getattr(props, 'uuid', d.index)}"


def init_multihost(coordinator_address: str, num_processes: int, process_id: int, *, devices: Sequence,
                   timeout: Optional[float] = None) -> None:
    """Join the group as process ``process_id`` of ``num_processes``, with
    ``devices`` (this process's devices, in order) as its part of the
    global device set. The default group
    is the control group (gloo, on the CPU); the data group's backend is
    NCCL where every device of the group is a card of its own, gloo
    otherwise. A data-group collective waits at most ``timeout`` seconds
    (default ``group_timeout()``); a worker waits for the leader's next op
    without bound."""
    import torch.distributed as dist

    if _STATE.get("done"):
        return
    _GROUP_STATE["degraded"] = None  # a new group: an earlier group's failure does not carry over
    timeout = group_timeout() if timeout is None else float(timeout)
    local = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in local) and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass CPU devices to run on the CPU explicitly")
    # the leader's control waits are bounded; a worker idles between ops
    ctrl_timeout = timeout if process_id == 0 else 365 * 86400.0
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=ctrl_timeout),
    )
    table: List[Optional[list]] = [None] * int(num_processes)
    dist.all_gather_object(table, [str(d) for d in local] + [_device_key(d) for d in local])
    per_process = [row[: len(row) // 2] for row in table]
    keys = [k for row in table for k in row[len(row) // 2 :]]
    all_cards = all(k.split("/")[1] == "cuda" for k in keys)
    backend = "nccl" if all_cards and len(set(keys)) == len(keys) and dist.is_nccl_available() else "gloo"
    data = dist.new_group(backend=backend, timeout=datetime.timedelta(seconds=timeout))
    _STATE.update(done=True, rank=int(process_id), world=int(num_processes), local=local,
                  counts=[len(r) for r in per_process], backend=backend, data=data, timeout=timeout)
    logger.info(
        f"multihost: process {process_id}/{num_processes}, {len(local)} local / {len(keys)} global devices, "
        f"data group on {backend}"
    )


def data_backend() -> Optional[str]:
    """The data group's backend ("nccl" or "gloo"), None outside a group."""
    return _STATE.get("backend")


def multihost_layout(tp: Optional[int] = None, sp: int = 1) -> Tuple[GroupLayout, List[torch.device]]:
    """This process's place in the serving grid over the GLOBAL device set
    (every process's devices, in process order): 1-D tp, or tp x sp. The
    same refusals as the JAX package's ``multihost_mesh`` for too few
    devices; besides, the grid must split evenly over the processes, each
    holding whole rows of sp ranks or a run of one row's ranks. Returns
    (layout, this process's entries' devices, shard-major)."""
    import torch.distributed as dist

    if not _STATE.get("done"):
        raise RuntimeError("init_multihost must run before multihost_layout")
    world, rank, counts = int(_STATE["world"]), int(_STATE["rank"]), list(_STATE["counts"])
    total = sum(counts)
    sp = sp or 1
    if tp is None:
        tp, rem = divmod(total, sp)
        if tp == 0:
            raise ValueError(
                f"multihost mesh sp={sp} needs at least {sp} devices, {total} available across {world} processes"
            )
        if rem:
            logger.warning(
                f"multihost mesh: {total} devices do not divide sp={sp}; serving on tp={tp} x sp={sp} = "
                f"{tp * sp} devices, {rem} idle"
            )
    need = tp * sp
    if tp < 1 or total < need:
        raise ValueError(
            f"multihost mesh tp={tp} x sp={sp} needs {need} devices (tp >= 1), {total} available across "
            f"{world} processes"
        )
    c, rem = divmod(need, world)
    if rem or c < 1 or min(counts) < c or not (c % sp == 0 or sp % c == 0):
        raise ValueError(
            f"multihost grid tp={tp} x sp={sp} does not split over {world} processes of {counts} devices: "
            f"each must hold the same number of entries, whole rows of the sp ranks or a run of one row's"
        )
    backend, data = _STATE["backend"], _STATE["data"]
    timeout = datetime.timedelta(seconds=float(_STATE["timeout"]))
    if c % sp == 0:  # whole rows: shards [rank * m, (rank + 1) * m) of every rank
        m = c // sp
        lay = GroupLayout(tp=tp, sp=sp, t0=rank * m, n_t=m, s0=0, n_s=sp, backend=backend,
                          tp_group=data if world > 1 else None, data_group=data)
    else:  # a run of one row: k processes a shard, c ranks each
        k = sp // c
        t0, j = divmod(rank, k)
        lay = GroupLayout(tp=tp, sp=sp, t0=t0, n_t=1, s0=j * c, n_s=c, backend=backend,
                          sp_prev=t0 * k + (j - 1) % k, sp_next=t0 * k + (j + 1) % k, sp_index=j, sp_procs=k,
                          data_group=data)
        # every process creates every group, in one order
        for jj in range(k):
            g = dist.new_group([q * k + jj for q in range(tp)], backend=backend, timeout=timeout) if tp > 1 else None
            if jj == j:
                lay.tp_group = g
        for tt in range(tp):
            g = dist.new_group([tt * k + jj for jj in range(k)], backend=backend, timeout=timeout)
            if tt == t0:
                lay.sp_group = g
    local = list(_STATE["local"])[:c]
    logger.info(f"multihost layout: shards [{lay.t0}, {lay.t0 + lay.n_t}) x ranks [{lay.s0}, {lay.s0 + lay.n_s}) "
                f"of tp={tp} x sp={sp} on {','.join(map(str, local))}")
    return lay, local


def shutdown_multihost() -> None:
    """Leave the group (a re-formed or finished process): destroy the
    process groups and forget the layout and the mirrors. A degraded or
    released group stays so until the next ``init_multihost``: a straggler
    free skips its broadcast."""
    import torch.distributed as dist

    if _STATE.get("done") and dist.is_initialized():
        with contextlib.suppress(Exception):
            dist.destroy_process_group()
    _STATE.clear()
    _MIRRORS.clear()


def _bcast_header(values=None) -> list:
    import torch.distributed as dist

    header = torch.zeros((_HEADER_LEN,), dtype=torch.int64)
    if values is not None:
        header[: len(values)] = torch.tensor([int(x) for x in values], dtype=torch.int64)
    dist.broadcast(header, src=0)
    _STATE["ops"] = _STATE.get("ops", 0) + 1
    return header.tolist()


def ops_broadcast() -> int:
    """The op headers this process has sent (the leader) or received (a
    worker) in its group: after its n-th op a worker has received n."""
    return int(_STATE.get("ops", 0))


def _bcast_array(arr, shape, dtype) -> torch.Tensor:
    """Broadcast one operand on the control group (the leader sends; the
    workers pass None and receive into zeros of the announced shape)."""
    import torch.distributed as dist

    dtype = {np.float32: torch.float32, np.int64: torch.int64}[dtype]
    if arr is None:
        t = torch.zeros(tuple(shape), dtype=dtype)
    else:
        t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr)
        t = t.detach().to("cpu", dtype).reshape(tuple(shape)).contiguous()
    dist.broadcast(t, src=0)
    return t


def _adapter_digest(adapters) -> int:
    """31-bit digest of the sorted adapter-name list: leader and workers must
    agree on the index->name mapping, not just the count (the JAX package's
    bytes: the first 4 bytes of the SHA-256, shifted right by one)."""
    blob = ",".join(sorted(adapters)).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:4], "big") >> 1


def _key(buf) -> Tuple[int, tuple]:
    return int(buf.data_ptr()), tuple(buf.shape)


class LaneCheckout(tuple):
    """The leader's (k, v) views of a lane checked out of the pool, with
    ``handle``, the synthetic handle the workers hold their views under."""

    def __new__(cls, kv, handle: int):
        self = super().__new__(cls, kv)
        self.handle = int(handle)
        return self


def _register_mirror(kv, handle: int) -> None:
    """Name the leader's allocation ``kv`` (a (k, v) pair) by its workers'
    handle. A live allocation is never renamed."""
    key = _key(kv[0])
    if _MIRRORS.get(key, handle) != handle:
        raise RuntimeError(f"cache {key} is already mirrored as handle {_MIRRORS[key]}, not {handle}")
    _MIRRORS[key] = int(handle)


def _forget_mirror(handle: int) -> None:
    for key in [k for k, h in _MIRRORS.items() if h == int(handle)]:
        del _MIRRORS[key]


def _mirror_of(kv) -> int:
    """The workers' handle of the leader's cache ``kv``: a check-out's own,
    else its allocation's."""
    if isinstance(kv, LaneCheckout):
        return kv.handle
    try:
        return _MIRRORS[_key(kv[0])]
    except KeyError:
        raise KeyError("this cache has no lockstep mirror on the workers (not allocated through the "
                       "lockstep memory cache or checked out of its lane pool)") from None


def _gather_heads(kv, b0: int, b1: int, position: int, layout: GroupLayout) -> Optional[tuple]:
    """Blocks [b0, b1), rows [0, position) of every process's head shards
    of ``kv``, joined along the head axis on the leader (None elsewhere):
    a gather on the control group every process enters."""
    import torch.distributed as dist

    mine = [buf[b0:b1, :, :position] for buf in kv]
    mine = [m.join("cpu") if hasattr(m, "join") else m.to("cpu") for m in mine]
    world, rank = int(_STATE["world"]), int(_STATE["rank"])
    gathered = [None] * world
    dist.all_gather_object(gathered, [(layout.t0, layout.s0)] + [m.float() for m in mine])
    if rank != 0:
        return None
    # one copy of each run of shards: the processes that hold sp rank 0
    rows = sorted((g for g in gathered if g[0][1] == 0), key=lambda g: g[0][0])
    return tuple(torch.cat([g[1 + i] for g in rows], dim=-2) for i in range(2))


class LockstepBackend:
    """Leader-side wrapper with the TransformerBackend surface the handler
    and server use. Attribute access falls through to the wrapped backend;
    the compute methods broadcast before computing. A cache's mirror on the
    workers is found from the cache (``handles`` names it explicitly); a
    step on a checked-out lane returns the check-out."""

    # class attribute (NOT via __getattr__, which only fires for misses):
    # the handler gates sub-span wrapping and KV export/import on this
    is_lockstep = True

    def __init__(self, backend, *, span: Tuple[int, int] = None, retired_state=None):
        self._backend = backend
        self._span = span or (0, backend.n_blocks)
        # shared across sub-views: a live span move RETIRES the old wrapper —
        # sessions that captured it must fail their next op per-request
        # (client failover) instead of broadcasting against worker mirrors the
        # reload cleared, which would KeyError the worker loop and degrade the
        # whole group
        self._retired_state = retired_state if retired_state is not None else {"retired": False}

    def _check_live(self) -> None:
        if self._retired_state["retired"]:
            raise RuntimeError(
                "This span was moved by a live rebalance; the session's server-side state is gone — "
                "re-open through routing (client failover)"
            )

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def sub_view(self, backend_slice, start: int, end: int) -> "LockstepBackend":
        """Lockstep view over a partial chain (handler._sub_backend)."""
        base = self._span[0]
        return LockstepBackend(backend_slice, span=(base + start, base + end), retired_state=self._retired_state)

    def _adapter_code(self, active_adapter) -> int:
        """Adapters cross the control plane as 1-based indices into the
        SORTED adapter-name list; leader and workers host identical sets, and
        a digest of the list rides along (header slot 11) so a drifted worker
        fails loud instead of applying the wrong adapter."""
        if not active_adapter:
            return 0
        names = sorted(self._backend.adapters)
        try:
            return names.index(active_adapter) + 1
        except ValueError:
            raise KeyError(f"Adapter {active_adapter!r} is not loaded on this server") from None

    def _digest(self, code: int) -> int:
        return _adapter_digest(self._backend.adapters) if code else 0

    # ------------------------------------------------------------- compute ops

    def inference_step(self, hidden, kv, position, *, prompts=None, hypo_ids=None, active_adapter=None,
                       handles=None, n_total=None):
        self._check_live()
        code = self._adapter_code(active_adapter)
        batch, seq, _ = hidden.shape
        flags = (_FLAG_PROMPTS if prompts is not None else 0) | (_FLAG_HYPO if hypo_ids is not None else 0)
        pre_seq = 0 if prompts is None else prompts.shape[2]
        mirror = _mirror_of(kv) if handles is None else int(handles[0])
        b0, b1 = self._span
        hs = self._backend.hidden_size
        with _BCAST_LOCK, _degrade_on_failure():
            # n_total rides the n_valid slot so every process picks the same
            # longrope branch
            _bcast_header([OP_INFERENCE_STEP, mirror, batch, seq, int(position),
                           -1 if n_total is None else int(n_total), flags, pre_seq, code, b0, b1,
                           self._digest(code)])
            hidden = _bcast_array(hidden, (batch, seq, hs), np.float32)
            if prompts is not None:
                prompts = _bcast_array(prompts, (b1 - b0, batch, pre_seq, hs), np.float32)
            if hypo_ids is not None:
                hypo_ids = _bcast_array(hypo_ids, (batch,), np.int64)
            out, kv_out = self._backend.inference_step(hidden, kv, position, prompts=prompts, hypo_ids=hypo_ids,
                                                       active_adapter=active_adapter, n_total=n_total)
        return out, LaneCheckout(kv_out, kv.handle) if isinstance(kv, LaneCheckout) else kv_out

    def forward(self, hidden, prompts=None, active_adapter=None):
        self._check_live()
        code = self._adapter_code(active_adapter)
        batch, seq, _ = hidden.shape
        flags = _FLAG_PROMPTS if prompts is not None else 0
        pre_seq = 0 if prompts is None else prompts.shape[2]
        b0, b1 = self._span
        hs = self._backend.hidden_size
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_FORWARD, -1, batch, seq, 0, -1, flags, pre_seq, code, b0, b1, self._digest(code)])
            hidden = _bcast_array(hidden, (batch, seq, hs), np.float32)
            if prompts is not None:
                prompts = _bcast_array(prompts, (b1 - b0, batch, pre_seq, hs), np.float32)
            return self._backend.forward(hidden, prompts=prompts, active_adapter=active_adapter)

    def backward(self, hidden, grad_out, prompts=None, active_adapter=None):
        self._check_live()
        code = self._adapter_code(active_adapter)
        batch, seq, _ = hidden.shape
        flags = _FLAG_PROMPTS if prompts is not None else 0
        pre_seq = 0 if prompts is None else prompts.shape[2]
        b0, b1 = self._span
        hs = self._backend.hidden_size
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_BACKWARD, -1, batch, seq, 0, -1, flags, pre_seq, code, b0, b1, self._digest(code)])
            # operand order mirrors the worker's generic decode: hidden, then
            # prompts (if flagged), then the op's own grad_out
            hidden = _bcast_array(hidden, (batch, seq, hs), np.float32)
            if prompts is not None:
                prompts = _bcast_array(prompts, (b1 - b0, batch, pre_seq, hs), np.float32)
            grad_out = _bcast_array(grad_out, (batch, seq, hs), np.float32)
            return self._backend.backward(hidden, grad_out, prompts=prompts, active_adapter=active_adapter)

    # ------------------------------------------------------- continuous batching

    def batched_decode_step(self, hidden, pool_kv, positions, handles=None):
        """One coalesced decode step over the whole mirrored lane pool:
        hidden and positions broadcast, every process steps its shards."""
        self._check_live()
        n_lanes = int(hidden.shape[0])
        mirror = _mirror_of(pool_kv) if handles is None else int(handles[0])
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_BATCHED_DECODE, mirror, n_lanes])
            hidden = _bcast_array(hidden, (n_lanes, 1, self._backend.hidden_size), np.float32)
            positions = _bcast_array(np.asarray(positions, np.int64), (n_lanes,), np.int64)
            return self._backend.batched_decode_step(hidden, pool_kv, positions)

    def lane_extract(self, k_pool, v_pool, lane: int, *, pool_handle: int, temp_handle: int):
        """Check a lane OUT of the pool on every process: each registers its
        pool's lane (a view, written in place as on one process) under the
        synthetic ``temp_handle``, so exclusive ops address it like session
        KV. Returns the leader's lane view as a ``LaneCheckout``."""
        self._check_live()
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_LANE_EXTRACT, int(pool_handle), int(lane), int(temp_handle)])
            return LaneCheckout(self._backend.dense_lane_view(k_pool, v_pool, lane), temp_handle)

    def lane_insert(self, k_pool, v_pool, kv_lane, lane: int, *, pool_handle: int, temp_handle: int):
        """Check a lane back IN on every process: the ops wrote every
        process's view in place, so nothing is copied; the workers drop
        their ``temp_handle`` mirror. ``kv_lane`` must be the checked-out
        view (a copy would leave the workers' lanes behind)."""
        self._check_live()
        view = self._backend.dense_lane_view(k_pool, v_pool, lane)
        if getattr(kv_lane, "handle", None) != int(temp_handle) or _key(kv_lane[0]) != _key(view[0]):
            raise ValueError("a lockstep lane is checked in as the view it was checked out as")
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_LANE_INSERT, int(pool_handle), int(lane), int(temp_handle)])
        return k_pool, v_pool

    def release_temp(self, temp_handle: int) -> None:
        """Drop a synthetic mirror that will not be inserted back (read-only
        extracts, failed ops). Rides OP_FREE — workers pop the id."""
        if _GROUP_STATE["degraded"] is not None:
            return
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_FREE, int(temp_handle), 1])

    # ------------------------------------------------------- KV export/import

    def export_kv(self, kv, b0: int, b1: int, position: int):
        """Host copy of blocks [b0, b1), rows [0, position) of a mirrored
        cache, every process's head shards gathered to the leader: the
        migration / drain / park path under lockstep. Returns (k, v) float32
        [b1 - b0, batch, position, hkv, d] CPU tensors."""
        self._check_live()
        mirror = _mirror_of(kv)
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_EXPORT_KV, mirror, b0, b1, int(position)])
            k, v = _gather_heads(kv, b0, b1, int(position), self._backend.layout)
        return k.to(kv[0].dtype), v.to(kv[1].dtype)

    def seed_cache(self, kv, k_rows, v_rows) -> None:
        """The backend's ``seed_cache`` on every process: the prefix is
        broadcast once and each process writes its own heads of it into its
        mirror of ``kv`` (rows past it zeroed)."""
        self._check_live()
        mirror = _mirror_of(kv)
        n, batch, position = int(k_rows.shape[0]), int(k_rows.shape[1]), int(k_rows.shape[2])
        shape = (n, batch, position, self._backend.num_kv_heads, self._backend.head_dim)
        with _BCAST_LOCK, _degrade_on_failure():
            _bcast_header([OP_IMPORT_KV, mirror, position, n, batch, int(kv[0].shape[2])])
            k_rows = _bcast_array(k_rows, shape, np.float32)
            v_rows = _bcast_array(v_rows, shape, np.float32)
            self._backend.seed_cache(kv, k_rows, v_rows)

    def reload_span(self, new_first_block: int, build_backend) -> "LockstepBackend":
        """LIVE SPAN MOVE: broadcast the new first block and rebuild leader
        and workers in lockstep. ``build_backend()`` is the leader's rebuild;
        it runs UNDER the broadcast lock so nothing can interleave. Callers
        must have quiesced session compute first (park + queue barrier).
        Returns the new leader-side wrapper."""
        with _BCAST_LOCK, _degrade_on_failure():
            self._retired_state["retired"] = True  # fence BEFORE the swap
            _MIRRORS.clear()
            _bcast_header([OP_RELOAD_SPAN, int(new_first_block)])
            backend = build_backend()
        return LockstepBackend(backend)

    def shutdown_workers(self) -> None:
        """Release the workers (they leave ``LockstepWorker.run``); every
        later op of this group fails fast, and a free skips its broadcast."""
        if _GROUP_STATE["degraded"] is not None:
            return  # the group is gone; a release broadcast would only fail
        with _BCAST_LOCK:
            _bcast_header([OP_SHUTDOWN])
            _GROUP_STATE["degraded"] = RuntimeError("the lockstep workers were released (shutdown)")


class LockstepMemoryCache:
    """Leader-side MemoryCache wrapper: the same budget and queueing
    (delegation), but reservation and free broadcast ALLOC/FREE so every
    worker mirrors the buffers for the same handles. The buffers are made
    at reserve time, in lockstep; free always runs leader-side."""

    def __init__(self, memory_cache):
        self._cache = memory_cache
        orig_reserve, orig_free = memory_cache._reserve, memory_cache._free

        def reserve(descriptors, alloc_size):
            _check_group()  # before booking anything the broadcast cannot mirror
            handles = orig_reserve(descriptors, alloc_size)
            d = descriptors[0]
            try:
                with _BCAST_LOCK, _degrade_on_failure():
                    # [op, h0, n, batch, max_len, hkv, hd, n_descr]
                    _bcast_header([OP_ALLOC, handles[0], *d.shape, len(descriptors)])
                    bufs = memory_cache.get_buffers(*handles)
                _register_mirror(bufs, handles[0])
            except BaseException:
                orig_free(handles)  # never strand booked budget on failure
                raise
            return handles

        def free(handles):
            # the leader-side free ALWAYS runs — on a degraded group the
            # mirrors died with the workers, but draining sessions still
            # return their budget. A broadcast failure here still marks the
            # group degraded but never propagates out of cleanup.
            try:
                if handles:
                    _forget_mirror(handles[0])
                if handles and _GROUP_STATE["degraded"] is None:
                    with _BCAST_LOCK, _degrade_on_failure():
                        _bcast_header([OP_FREE, handles[0], len(handles)])
            except MultihostDegraded as e:
                logger.warning(f"FREE broadcast failed on a degraded group: {e}")
            finally:
                orig_free(handles)

        memory_cache._reserve = reserve
        memory_cache._free = free

    def __getattr__(self, name):
        return getattr(self._cache, name)


class LockstepWorker:
    """Non-leader process: mirrors allocations and executes the leader's
    compute ops in lockstep until OP_SHUTDOWN. ``rebuild_fn(new_first_block)
    -> TransformerBackend`` enables live span moves (OP_RELOAD_SPAN);
    without it a reload op stops the worker with an error. ``after_op()``,
    when given, runs after every op (cli/run_worker.py reports its kernel
    launches there)."""

    def __init__(self, backend, rebuild_fn=None, after_op=None):
        self.backend = backend
        self.rebuild_fn = rebuild_fn
        self.after_op = after_op
        self._kv: Dict[int, Tuple] = {}
        self._subs: Dict[Tuple[int, int], object] = {}

    def _sub(self, b0: int, b1: int):
        if (b0, b1) == (0, self.backend.n_blocks):
            return self.backend
        key = (b0, b1)
        if key not in self._subs:
            self._subs[key] = self.backend.sub_backend(b0, b1)
        sub = self._subs[key]
        # the leader handler's sub-backend adapter slicing
        sub.adapters = {name: (per_block[b0:b1], scaling)
                        for name, (per_block, scaling) in self.backend.adapters.items()}
        return sub

    def _adapter_name(self, code: int, digest: int):
        if code == 0:
            return None
        names = sorted(self.backend.adapters)
        if code > len(names) or digest != _adapter_digest(names):
            raise RuntimeError(
                f"Leader requested adapter #{code} of a set with digest {digest} but this worker hosts "
                f"{names} — leader and workers must be started with identical --adapters flags"
            )
        return names[code - 1]

    def run(self) -> None:
        logger.info(f"multihost worker {_STATE.get('rank')}: serving lockstep ops")
        while True:
            if self.after_op is not None:
                self.after_op()
            header = _bcast_header()
            op = header[0]
            if op == OP_SHUTDOWN:
                logger.info("multihost worker: shutdown")
                return
            if op == OP_ALLOC:
                # [op, h0, n, batch, max_len, hkv, hd, n_descr]
                _, h0, n, batch, max_len = header[:5]
                kd, vd = self.backend.cache_descriptors(batch, max_len, 0, n)
                self._kv[h0] = (kd.make_zeros(), vd.make_zeros())
                continue
            if op == OP_FREE:
                self._kv.pop(header[1], None)
                continue
            if op == OP_EXPORT_KV:
                # [op, mirror, b0, b1, position]: enter the gather
                _, mirror, b0, b1, position = header[:5]
                _gather_heads(self._kv[mirror], b0, b1, position, self.backend.layout)
                continue
            if op == OP_IMPORT_KV:
                # [op, mirror, position, n, batch, max_len]
                _, mirror, position, n, batch, _max_len = header[:6]
                shape = (n, batch, position, self.backend.num_kv_heads, self.backend.head_dim)
                k_rows = _bcast_array(None, shape, np.float32)
                v_rows = _bcast_array(None, shape, np.float32)
                self.backend.seed_cache(self._kv[mirror], k_rows, v_rows)
                continue
            if op == OP_RELOAD_SPAN:
                new_first = header[1]
                if self.rebuild_fn is None:
                    raise RuntimeError(
                        "leader requested a live span move but this worker has no rebuild_fn — restart the "
                        "group to move spans"
                    )
                logger.info(f"multihost worker: live span move to first_block={new_first}")
                self._kv.clear()
                self._subs.clear()
                # release the OLD span's weights BEFORE loading the new ones
                self.backend = None
                self.backend = self.rebuild_fn(int(new_first))
                continue
            if op == OP_BATCHED_DECODE:
                _, pool_h, n_lanes = header[:3]
                hidden = _bcast_array(None, (n_lanes, 1, self.backend.hidden_size), np.float32)
                positions = _bcast_array(None, (n_lanes,), np.int64)
                self.backend.batched_decode_step(hidden, self._kv[pool_h], positions)
                continue
            if op == OP_LANE_EXTRACT:
                _, pool_h, lane, temp = header[:4]
                self._kv[temp] = self.backend.dense_lane_view(*self._kv[pool_h], lane)
                continue
            if op == OP_LANE_INSERT:
                self._kv.pop(header[3], None)
                continue

            # compute ops: [op, mirror, batch, seq, position, n_total, flags,
            #               pre_seq, adapter_code, b0, b1, adapter_digest]
            (_, mirror, batch, seq, position, n_total, flags, pre_seq, code, b0, b1, digest) = header[:12]
            hs = self.backend.hidden_size
            hidden = _bcast_array(None, (batch, seq, hs), np.float32)
            prompts = None
            if flags & _FLAG_PROMPTS:
                prompts = _bcast_array(None, (b1 - b0, batch, pre_seq, hs), np.float32)
            backend = self._sub(b0, b1)
            adapter = self._adapter_name(code, digest)
            if op == OP_INFERENCE_STEP:
                hypo_ids = _bcast_array(None, (batch,), np.int64) if flags & _FLAG_HYPO else None
                backend.inference_step(hidden, self._kv[mirror], position, prompts=prompts, hypo_ids=hypo_ids,
                                       active_adapter=adapter, n_total=None if n_total < 0 else int(n_total))
            elif op == OP_FORWARD:
                backend.forward(hidden, prompts=prompts, active_adapter=adapter)
            elif op == OP_BACKWARD:
                grad_out = _bcast_array(None, (batch, seq, hs), np.float32)
                backend.backward(hidden, grad_out, prompts=prompts, active_adapter=adapter)
            else:
                raise RuntimeError(f"multihost worker: unknown op {op}")


__all__ = [
    "OP_SHUTDOWN", "OP_ALLOC", "OP_FREE", "OP_INFERENCE_STEP", "OP_FORWARD", "OP_BACKWARD", "OP_EXPORT_KV",
    "OP_IMPORT_KV", "OP_BATCHED_DECODE", "OP_LANE_EXTRACT", "OP_LANE_INSERT", "OP_RELOAD_SPAN",
    "MultihostDegraded", "group_degraded", "init_multihost", "multihost_layout", "shutdown_multihost",
    "LockstepBackend", "LockstepMemoryCache", "LockstepWorker", "LaneCheckout", "data_backend", "ops_broadcast",
]
