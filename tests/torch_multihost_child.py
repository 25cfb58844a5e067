"""The child processes of tests/test_torch_multihost*.py: a port leader that
drives the lockstep ops (LockstepBackend + LockstepMemoryCache, as the
handler and batcher drive them) and writes what came out, and a port worker
(LockstepWorker) over the same checkpoint. Run as

    python -m tests.torch_multihost_child <role> <model> <coordinator> <world> <rank> <tp> <sp> <out.npz>

with role ``core``, ``sp`` or ``adapter`` (leaders, rank 0) or ``worker``
(``$MH_ADAPTERS``: PEFT checkpoints every process of a role hosts), or ``server``
(a leader ``Server`` beside a ``cli/run_worker.py`` process). Every process
holds its entries of the tp x sp grid on the CPU, float32, data group on gloo.
"""

import asyncio
import os
import sys

import numpy as np
import torch

from petals_tpu_torch.parallel import collectives
from petals_tpu_torch.parallel import multihost as mh
from petals_tpu_torch.server.backend import TransformerBackend
from petals_tpu_torch.server.from_pretrained import get_block_config, load_block_params
from petals_tpu_torch.server.memory_cache import MemoryCache

SEED = 0


def inputs(hidden_size: int, n_blocks: int) -> dict:
    """The seeded inputs every side of a comparison feeds."""
    rng = np.random.RandomState(SEED)
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    return {
        "prefill": f(2, 6, hidden_size), "step": f(2, 1, hidden_size), "prompts": f(n_blocks, 2, 2, hidden_size),
        "hypo": np.array([1, 0], np.int64), "fwd": f(2, 8, hidden_size), "grad": f(2, 8, hidden_size),
        "lanes": f(3, 1, hidden_size), "lane_prefill": f(1, 4, hidden_size), "long": f(1, 8, hidden_size),
    }


def build(model: str, world: int, rank: int, tp: int, sp: int) -> TransformerBackend:
    family, cfg = get_block_config(model)
    n = cfg.num_hidden_layers
    per_process = tp * sp // world
    mh.init_multihost(COORD, world, rank, devices=["cpu"] * per_process, timeout=20.0)
    layout, local = mh.multihost_layout(tp, sp)
    blocks = [load_block_params(model, i, dtype=torch.float32, device="cpu", family=family, cfg=cfg)
              for i in range(n)]
    backend = TransformerBackend(family, cfg, blocks, first_block=0, n_blocks=n, device="cpu",
                                 compute_dtype=torch.float32, use_flash=False, tp_devices=local,
                                 num_sp_devices=layout.n_s, layout=layout)
    install_adapters(backend, os.environ.get("MH_ADAPTERS", ""))
    return backend


def install_adapters(backend, paths: str) -> None:
    """The PEFT checkpoints of ``paths`` (os.pathsep-separated) on every
    block of ``backend``, as the server installs them."""
    from petals_tpu_torch.utils.peft import load_adapter, stack_adapter

    for path in filter(None, paths.split(os.pathsep)):
        adapter = load_adapter(path, backend.family.name, block_range=range(backend.n_blocks))
        backend.adapters[adapter.name] = (stack_adapter(adapter, 0, backend.n_blocks, torch.float32, "cpu"),
                                          adapter.scaling)


def np_(x) -> np.ndarray:
    return x.detach().cpu().float().numpy()


async def core(backend: TransformerBackend, out_path: str) -> None:
    """Steps with prompts and hypo_ids, export and import, forward,
    backward, the batched decode and a lane's check-out and check-in, then
    the same on a one-lane pool, whose lane has the pool's own address and
    shape: a prefill on its check-out, a batched decode, a snapshot and a
    second batched decode."""
    lb = mh.LockstepBackend(backend)
    mc = mh.LockstepMemoryCache(MemoryCache(None))
    x = inputs(backend.hidden_size, backend.n_blocks)
    t = torch.from_numpy
    res = {}
    n = backend.n_blocks
    async with mc.allocate_cache(*backend.cache_descriptors(2, 32, 0, n)) as handles:
        kv = tuple(mc.get_buffers(*handles))
        res["out1"], _ = lb.inference_step(t(x["prefill"]), kv, 0)
        res["out2"], _ = lb.inference_step(t(x["step"]), kv, 6)
        res["out3"], _ = lb.inference_step(t(x["step"]), kv, 7, prompts=t(x["prompts"]))
        res["out4"], _ = lb.inference_step(t(x["step"]), kv, 8, hypo_ids=t(x["hypo"]))
        res["k"], res["v"] = lb.export_kv(kv, 0, n, 9)
        async with mc.allocate_cache(*backend.cache_descriptors(2, 32, 0, n)) as h2:
            kv2 = tuple(mc.get_buffers(*h2))
            lb.seed_cache(kv2, res["k"], res["v"])
            res["imported"], _ = lb.inference_step(t(x["step"]), kv2, 9)
    res["fwd"] = lb.forward(t(x["fwd"]))
    res["g_in"], res["g_prompts"] = lb.backward(t(x["fwd"]), t(x["grad"]), prompts=t(x["prompts"][:, :, :2]))
    async with mc.allocate_cache(*backend.cache_descriptors(3, 32, 0, n)) as ph:
        pool = tuple(mc.get_buffers(*ph))
        lane = lb.lane_extract(*pool, 1, pool_handle=ph[0], temp_handle=-2)
        res["lane_prefill"], _ = lb.inference_step(t(x["lane_prefill"]), lane, 0)
        lb.lane_insert(*pool, lane, 1, pool_handle=ph[0], temp_handle=-2)
        res["decode"], _ = lb.batched_decode_step(t(x["lanes"]), pool, np.array([0, 4, 0], np.int32))
        res["lane_k"], res["lane_v"] = _snapshot(lb, backend, pool, ph, 1, 5)
    async with mc.allocate_cache(*backend.cache_descriptors(1, 32, 0, n)) as oh:
        one = tuple(mc.get_buffers(*oh))
        lane = lb.lane_extract(*one, 0, pool_handle=oh[0], temp_handle=-4)
        res["one_prefill"], lane = lb.inference_step(t(x["lane_prefill"]), lane, 0)
        lb.lane_insert(*one, lane, 0, pool_handle=oh[0], temp_handle=-4)
        res["one_decode1"], _ = lb.batched_decode_step(t(x["lanes"][:1]), one, np.array([4], np.int32))
        res["one_k"], res["one_v"] = _snapshot(lb, backend, one, oh, 0, 5, temp=-5)
        res["one_decode2"], _ = lb.batched_decode_step(t(x["lanes"][1:2]), one, np.array([5], np.int32))
    lb.shutdown_workers()
    np.savez(out_path, **{k: np_(v) for k, v in res.items()}, crossings=np.array(
        [collectives.CROSSINGS[k] for k in ("all_reduce", "all_gather", "ring")]))


def _snapshot(lb, backend, pool, ph, lane: int, position: int, temp: int = -3):
    """A pooled lane's rows read out as the batcher's ``snapshot_lane``
    does under lockstep: a read-only check-out, the export, the release."""
    view = lb.lane_extract(*pool, lane, pool_handle=ph[0], temp_handle=temp)
    try:
        return lb.export_kv(view, 0, backend.n_blocks, position)
    finally:
        lb.release_temp(temp)


async def sp_run(backend: TransformerBackend, out_path: str) -> None:
    """The ring's forward and backward and a query-sharded cached prefill."""
    lb = mh.LockstepBackend(backend)
    mc = mh.LockstepMemoryCache(MemoryCache(None))
    x = inputs(backend.hidden_size, backend.n_blocks)
    t = torch.from_numpy
    res = {}
    collectives.reset_reduction_count()
    from petals_tpu_torch.ops import ring_attention

    ring_attention.reset_fold_count()
    res["fwd"] = lb.forward(t(x["fwd"]))
    res["g_in"], _ = lb.backward(t(x["fwd"]), t(x["grad"]))
    async with mc.allocate_cache(*backend.cache_descriptors(1, 32, 0, backend.n_blocks)) as handles:
        kv = tuple(mc.get_buffers(*handles))
        res["prefill"], _ = lb.inference_step(t(x["long"]), kv, 0)
        res["decode"], _ = lb.inference_step(t(x["step"][:1]), kv, 8)
        res["k"], res["v"] = lb.export_kv(kv, 0, backend.n_blocks, 9)
    lb.shutdown_workers()
    np.savez(out_path, **{k: np_(v) for k, v in res.items()}, folds=np.array(ring_attention.fold_count()),
             crossings=np.array([collectives.CROSSINGS[k] for k in ("all_reduce", "all_gather", "ring")]))


async def adapter_run(backend: TransformerBackend, out_path: str) -> None:
    """A session's steps, a forward and a backward with the LoRA adapter
    "lora-tp" active (it crosses as an index into the sorted names with
    their digest); an adapter the leader does not host fails before any
    broadcast. A worker whose adapter set differs stops at the first
    adapter op, and the leader's op raises MultihostDegraded: recorded as
    ``mismatch``."""
    lb = mh.LockstepBackend(backend)
    mc = mh.LockstepMemoryCache(MemoryCache(None))
    x = inputs(backend.hidden_size, backend.n_blocks)
    t = torch.from_numpy
    res = {}
    try:
        lb.forward(t(x["fwd"]), active_adapter="no-such-adapter")
    except KeyError:
        res["unknown_refused"] = np.array(1)
    try:
        async with mc.allocate_cache(*backend.cache_descriptors(2, 32, 0, backend.n_blocks)) as handles:
            kv = tuple(mc.get_buffers(*handles))
            res["out1"], _ = lb.inference_step(t(x["prefill"]), kv, 0, active_adapter="lora-tp")
            res["out2"], _ = lb.inference_step(t(x["step"]), kv, 6, active_adapter="lora-tp")
        res["fwd"] = lb.forward(t(x["fwd"]), active_adapter="lora-tp")
        res["g_in"], _ = lb.backward(t(x["fwd"]), t(x["grad"]), active_adapter="lora-tp")
        res["plain"] = lb.forward(t(x["fwd"]))
        lb.shutdown_workers()
    except mh.MultihostDegraded:
        res["mismatch"] = np.array(1)
    np.savez(out_path, **{k: np_(v) if isinstance(v, torch.Tensor) else v for k, v in res.items()})


async def serve_move_reform(model: str, out_path: str) -> None:
    """A leader ``Server`` (tp=2 over itself and one ``cli/run_worker.py``)
    on blocks [0, 2), its throughput probed at start on the group: a
    session's outputs, then a live span move to [2, 4)
    and a session there, then (once the test has killed the worker and
    written a line) a step that degrades the group, the health check's
    single-host re-formation, and a session on the re-formed server."""
    from petals_tpu_torch.data_structures import CHAIN_DELIMITER, make_uid
    from petals_tpu_torch.rpc.client import RpcClient
    from petals_tpu_torch.rpc.serialization import deserialize_array, serialize_array
    from petals_tpu_torch.server.server import Server, default_dht_prefix

    server = Server(model, first_block=0, num_blocks=2, device="cpu", compute_dtype=torch.float32, throughput="auto",
                    num_tp_devices=2, num_hosts=2, coordinator_address=COORD, update_period=1.0,
                    server_side_generation=False, prefix_cache_bytes=0)
    await server.start()
    x = inputs(server.cfg.hidden_size, 4)
    # auto-throughput was probed on the lockstep backend itself
    res = {"forward_rps": np.array(server._rps_info["forward_rps"]), "throughput": np.array(server.throughput)}
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)

    async def session(sid, first, batch=1):
        stream = await client.open_stream("ptu.inference")
        uids = CHAIN_DELIMITER.join(make_uid(default_dht_prefix(model), i) for i in range(first, first + 2))
        await stream.send({"uids": uids, "max_length": 32, "batch_size": batch, "session_id": sid})
        assert (await stream.recv(timeout=60))["session_open"]
        outs = []
        for h in (x["prefill"][:batch], x["step"][:batch]):
            await stream.send({"tensors": {"hidden": serialize_array(h)}})
            reply = await stream.recv(timeout=120)
            if "tensors" not in reply:
                raise RuntimeError(f"step failed: {reply}")
            outs.append(deserialize_array(reply["tensors"]["hidden"]).float().numpy())
        await stream.end()
        return np.concatenate(outs, axis=1)

    res["before"] = await session("before", 0)
    assert await server.resize(2)
    res["moved"] = await session("moved", 2)
    res["moved_private"] = await session("moved-private", 2, batch=2)
    print("KILL_WORKER", flush=True)
    await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
    try:
        await session("doomed", 2)
        res["degraded"] = np.array(0)
    except Exception as e:  # the step's error reply: the group lost its worker
        print(f"DEGRADED_STEP {e!r}"[:300], flush=True)
        res["degraded"] = np.array(1)
    for _ in range(120):  # the announce loop's health check re-forms single-host
        if server.num_hosts == 1 and server.handler is not None and not server.handler.draining:
            break
        await asyncio.sleep(0.5)
    res["reformed_hosts"] = np.array(server.num_hosts)
    res["reformed_throughput"] = np.array(server.throughput)
    await client.close()
    client = await RpcClient.connect("127.0.0.1", server.rpc_server.port)
    res["reformed"] = await session("reformed", 2)
    await client.close()
    await server.shutdown()
    np.savez(out_path, **res)


if __name__ == "__main__":
    role, model, COORD, world, rank, tp, sp, out_path = sys.argv[1:9]
    world, rank, tp, sp = int(world), int(rank), int(tp), int(sp)
    if role == "server":
        asyncio.run(serve_move_reform(model, out_path))
        print("LEADER_DONE", flush=True)
        sys.exit(0)
    backend = build(model, world, rank, tp, sp)
    if role == "worker":
        from petals_tpu_torch.ops import ring_attention

        mh.LockstepWorker(backend).run()
        print(f"WORKER_FOLDS {ring_attention.fold_count()}", flush=True)
    else:
        asyncio.run({"core": core, "sp": sp_run, "adapter": adapter_run}[role](backend, out_path))
        print("LEADER_DONE", flush=True)
    mh.shutdown_multihost()
